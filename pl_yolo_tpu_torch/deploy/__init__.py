"""Deployment from the port: the exporters (`deploy.export`: npz,
TorchScript, ONNX and a served `torch.export` program) and the host
runtimes of their artifacts, which need no torch: `numpy_infer` (the npz,
pure numpy), `onnx_numpy_runtime` (an ONNX graph, pure numpy), with the
protobuf writer `onnx_writer` and `torch_onnx` (torch's ONNX graph written
without the `onnx` package). The four runtime files are copies of the JAX
package's, which a test holds byte-equal to their originals.
"""

from .numpy_infer import forward, load_npz, postprocess  # noqa: F401
