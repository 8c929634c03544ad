"""Framework-free deployment interop for the port's nets.

ONNX without the onnx/onnxruntime packages: a protobuf codec for the
ONNX schema (onnx_proto) and a numpy graph interpreter that lets
``--eval`` run ``.onnx`` artifacts (onnx_run), both copies of the JAX
package's, and an exporter that records a torch net's forward into
ONNX ops (onnx_export).  A file either package writes runs in either
package's runner.
"""

from .onnx_export import export_onnx
from .onnx_run import OnnxModel

__all__ = ["OnnxModel", "export_onnx"]
