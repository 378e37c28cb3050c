"""Plain reference of the benchmark's cells: numpy and torch operations
only, float64 where it shades, with no import of the program, of JAX or of
the JAX package. It works out from the scene description and the seed
what the program derives (camera samples, rays, hits, shading, the film's
splat) and judges what the program's timed path produced."""
