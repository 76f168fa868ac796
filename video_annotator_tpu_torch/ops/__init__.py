"""Compute ops: warp, corners, LK, RANSAC, and the CUDA kernels K1-K3."""
