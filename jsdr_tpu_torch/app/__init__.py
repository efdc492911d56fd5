"""Command-line entry point of the port (``jsdr-tpu-torch``)."""
