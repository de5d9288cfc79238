"""Device-side compute kernels (pure JAX; all jittable, static shapes)."""
