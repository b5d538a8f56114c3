"""Hand-written CUDA kernels (sources in ../csrc), their builds and plain versions."""
