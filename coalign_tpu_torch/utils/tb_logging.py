"""TensorBoard metrics sink (ref criterion.logging -> tensorboardX).

Port of coalign_tpu/utils/tb_logging.py: the train loop's metrics
callback stream as TensorBoard scalars. Gated on import, as in the JAX
package: torch's bundled writer when it imports (it needs the
``tensorboard`` package), else tensorboardX, else the callback is the inner
one and closing does nothing.
"""

from __future__ import annotations


def _summary_writer():
    """A SummaryWriter class, or None when no TensorBoard writer imports."""
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter
    except Exception:
        try:
            from tensorboardX import SummaryWriter  # type: ignore
            return SummaryWriter
        except Exception:
            return None


def make_tb_callback(log_dir: str, inner=None):
    """Returns (callback, close): callback(metrics) writes every numeric
    entry as a scalar keyed ``train/<name>`` (val_loss as ``val/loss``),
    stepped by the dict's ``step``, then calls ``inner``.

    Returns (inner or a no-op, a no-op) when no TensorBoard writer
    imports."""
    writer_cls = _summary_writer()
    if writer_cls is None:
        return inner or (lambda m: None), lambda: None
    writer = writer_cls(log_dir=log_dir)

    def callback(metrics: dict):
        step = int(metrics.get("step", 0))
        for k, v in metrics.items():
            if k in ("step", "epoch"):
                continue
            if isinstance(v, (int, float)):
                tag = "val/loss" if k == "val_loss" else f"train/{k}"
                writer.add_scalar(tag, float(v), global_step=step)
        if inner:
            inner(metrics)

    def close():
        writer.flush()
        writer.close()

    return callback, close
