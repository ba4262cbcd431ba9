"""GPU counterparts of the JAX package's kernel probes (tools/)."""
