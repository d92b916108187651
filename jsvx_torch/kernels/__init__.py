"""Device math of the port: plain PyTorch spec, expansion, CUDA kernel."""
