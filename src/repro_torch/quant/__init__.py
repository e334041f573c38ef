"""Quantization grids, policies, the STE, and the sub-byte storage codec."""
