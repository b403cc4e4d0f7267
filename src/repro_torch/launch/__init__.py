"""Entry points of the port: the serving driver (``launch.serve``), the
FedPart trainer for the served architectures and the simulation's command
line (``launch.fedtrain``), the paper's end-to-end driver
(``launch.train``), the step builders they use (``launch.steps``: FNU and
partial train steps, prefill and decode), and the async runtime's device
slots (``launch.mesh``)."""
