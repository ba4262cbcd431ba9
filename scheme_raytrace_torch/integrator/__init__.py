"""Integrators: the fused bounce step, the general pool's hit query and
shading, and the regeneration pools."""
