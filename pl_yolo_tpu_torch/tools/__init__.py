"""Command-line tools of the port: `make_shapes_dataset` (a copy of the JAX
package's `tools/make_shapes_dataset.py`), `accuracy_gate`, and the deploy
tools (`export_npz`, `export_torchscript`, `export_onnx`, `export`,
`deploy_from_ckpt`, `inference_demo`, `onnx_demo`; `deploy_cli` holds what
they share)."""
