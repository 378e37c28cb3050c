"""The benchmark's scene inputs, shared by the program and the reference."""
