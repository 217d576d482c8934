"""Device ops: Hamming search (plain torch) and its CUDA kernel."""
