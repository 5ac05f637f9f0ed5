"""Event hook bus of the trainer and the predictor (port of
`sar_yolo_tpu/utils/callbacks/__init__.py`): each callback is called with the object that
runs the event. The logger integrations (TensorBoard, W&B, MLflow, ...) are not ported."""

from __future__ import annotations

_DEFAULT_EVENTS = [
    # trainer
    "on_pretrain_routine_start", "on_pretrain_routine_end", "on_train_start",
    "on_train_epoch_start", "on_train_batch_start", "optimizer_step",
    "on_before_zero_grad", "on_train_batch_end", "on_train_epoch_end",
    "on_fit_epoch_end", "on_model_save", "on_train_end", "on_params_update",
    "teardown",
    # validator
    "on_val_start", "on_val_batch_start", "on_val_batch_end", "on_val_end",
    # predictor
    "on_predict_start", "on_predict_batch_start", "on_predict_postprocess_end",
    "on_predict_batch_end", "on_predict_end",
    # exporter
    "on_export_start", "on_export_end",
]


def get_default_callbacks() -> dict:
    return {e: [] for e in _DEFAULT_EVENTS}


class HasCallbacks:
    """Mixin giving the trainer and the predictor the callback API."""

    def init_callbacks(self):
        self.callbacks = get_default_callbacks()

    def add_callback(self, event: str, func):
        self.callbacks.setdefault(event, []).append(func)

    def run_callbacks(self, event: str):
        for f in self.callbacks.get(event, []):
            f(self)
