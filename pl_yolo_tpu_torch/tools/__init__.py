"""Command-line tools of the port: `make_shapes_dataset` (a copy of the JAX
package's `tools/make_shapes_dataset.py`) and `accuracy_gate`."""
