"""Reference-format host IO: CSV, MNIST, synthesized data."""
