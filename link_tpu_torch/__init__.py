"""PyTorch/CUDA port of link_tpu: LinK sparse-voxel perception on NVIDIA
Hopper. The JAX package `link_tpu` stays the reference; this package imports
neither it nor JAX."""
