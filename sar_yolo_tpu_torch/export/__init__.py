"""ONNX writer, protobuf codec and numpy runtime of the port (used by engine/exporter.py and
nn/autobackend.py)."""
