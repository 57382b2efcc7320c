"""Ray generation, the bounce loop and its CUDA kernel, and the tone map."""
