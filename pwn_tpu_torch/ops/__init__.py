"""Tensor ops of the port: convolutions, the logistic base, and the flow
stack with its CUDA kernel."""
