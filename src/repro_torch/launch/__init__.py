"""Entry points of the port: the serving driver (``launch.serve``) and the
step builders it uses (``launch.steps``)."""
