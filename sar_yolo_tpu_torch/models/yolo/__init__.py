"""YOLO model families of the port with a facade of their own (YOLO-World)."""
