"""Multi-device geometry and data parallelism of the port."""
