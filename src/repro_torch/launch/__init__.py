"""Entry points of the port: the serving driver (``launch.serve``), the
step builders it uses (``launch.steps``), and the async runtime's device
slots (``launch.mesh``)."""
