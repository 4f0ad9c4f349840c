"""Hand-written CUDA kernels for Hopper, their ctypes wrappers and plain versions."""
