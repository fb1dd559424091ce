"""Special functions, dim-2 cached quadrature, bracketing, and the CUDA
kernel wrappers. Kernels build lazily at first CUDA launch."""
