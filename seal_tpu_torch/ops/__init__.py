"""Device operations of the port: u64 arithmetic, NTT, RNS, poly ops and the CUDA kernel wrappers."""
