"""Instant-NGP field, occupancy culling and the fused integer renderer."""
