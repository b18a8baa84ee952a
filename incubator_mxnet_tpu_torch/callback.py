"""Training callbacks of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/callback.py`; ref `python/mxnet/callback.py`):
Speedometer samples/sec lines (the format `tools/parse_log.py`
scrapes), the MFU meter, checkpointing, log-validation."""
from __future__ import annotations

import collections
import logging
import time

from . import telemetry

__all__ = ["BatchEndParam", "Speedometer", "MFUMeter", "do_checkpoint",
           "log_train_metric", "LogValidationMetricsCallback",
           "module_checkpoint"]

# ref python/mxnet/model.py BatchEndParam — the record batch callbacks receive
BatchEndParam = collections.namedtuple(
    "BatchEndParam", ["epoch", "nbatch", "eval_metric", "locals"])


class Speedometer:
    """Prints rolling samples/sec every `frequent` batches."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                elapsed = time.time() - self.tic
                speed = self.frequent * self.batch_size / elapsed
                if telemetry.enabled():
                    # same numbers the log line prints, as metrics; the
                    # printed output stays byte-identical
                    telemetry.gauge("speedometer_samples_per_sec") \
                        .set(speed)
                    telemetry.histogram("speedometer_step_seconds") \
                        .observe(elapsed / self.frequent)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset_local()
                    msg = self._speed_msg(param, count, speed)
                    for name, value in name_value:
                        msg += f"\t{name}={value:f}"
                    logging.info(msg)
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                                 param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()

    def _speed_msg(self, param, count, speed) -> str:
        """Subclass hook: the line prefix before the metric values."""
        return (f"Epoch[{param.epoch}] Batch [{count}]\t"
                f"Speed: {speed:.2f} samples/sec")


def device_peak_hbm_bytes_per_s(device=None):
    """Peak HBM bandwidth (bytes/s) of the card (device 0 by default),
    from `telemetry.perf.PEAKS`; None on the CPU or on a card the table
    does not name (a roofline share there is not measured)."""
    pk = telemetry.perf.peaks(device)
    return pk["hbm"] if pk else None


def device_peak_flops(device=None):
    """Dense bf16 peak FLOP/s of the card (device 0 by default), from
    `telemetry.perf.PEAKS`; None on the CPU or on a card the table does
    not name, where MFU is not measured (no nominal stand-in: a wrong
    denominator would make up an MFU)."""
    pk = telemetry.perf.peaks(device)
    return pk["flops"] if pk else None


class MFUMeter(Speedometer):
    """Speedometer that also reports model FLOPs utilization.

    `flops_per_sample`: analytic training FLOPs per sample (≈ 6·params
    per token × tokens for transformers, 3 × fwd-FLOPs for convnets).
    No reference counterpart.
    Inherits Speedometer's full state machine (epoch rollover, metric
    auto-reset); only the report line differs.  Without a peak (the
    CPU, a card `telemetry.perf.PEAKS` does not name) the line says
    ``MFU: not measured``.
    """

    def __init__(self, batch_size, flops_per_sample, frequent=50,
                 auto_reset=True, peak_flops=None):
        super().__init__(batch_size, frequent, auto_reset)
        self.flops_per_sample = float(flops_per_sample)
        self.peak_flops = peak_flops

    def _speed_msg(self, param, count, speed) -> str:
        if self.peak_flops is None:
            self.peak_flops = device_peak_flops()
        head = (f"Epoch[{param.epoch}] Batch [{count}]\t"
                f"Speed: {speed:.2f} samples/sec\tMFU: ")
        if not self.peak_flops:
            return head + "not measured"
        mfu = speed * self.flops_per_sample / self.peak_flops
        return head + f"{100 * mfu:.2f}%"


def do_checkpoint(prefix, period=1):
    """Epoch-end checkpoint callback (params + symbol json)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            from .utils import serialization

            if sym is not None and hasattr(sym, "save"):
                sym.save(f"{prefix}-symbol.json")
            arrays = {}
            for k, v in (arg or {}).items():
                arrays[f"arg:{k}"] = v
            for k, v in (aux or {}).items():
                arrays[f"aux:{k}"] = v
            serialization.save_ndarrays(f"{prefix}-{iter_no + 1:04d}.params", arrays)
            logging.info("Saved checkpoint to \"%s-%04d.params\"", prefix, iter_no + 1)

    return _callback


module_checkpoint = do_checkpoint


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset_local()

    return _callback


class LogValidationMetricsCallback:
    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name, value)
