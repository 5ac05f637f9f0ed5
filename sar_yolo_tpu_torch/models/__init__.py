"""Model-family facades of the port (RT-DETR, YOLO-World)."""
