"""One module per integrator that a configuration names: a ``Cell`` that
builds the program's scene from the benchmark's description, runs one
step, hands over what the step produced and judges it with the
reference."""
