"""`python -m sar_yolo_tpu_torch TASK MODE key=value ...`: the port's command line
(`cfg/__init__.py::entrypoint`) without installing the `saryolo-torch` script."""

from sar_yolo_tpu_torch.cfg import entrypoint

if __name__ == "__main__":
    entrypoint()
