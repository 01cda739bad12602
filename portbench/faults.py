"""Faults planted in the timed path, underneath the harness, for the
checks' own tests and for reading a fault's numbers on the chip.  Each is
a context manager that patches the port and puts it back."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def half_batch():
    """The train step sees half of each batch; its loss is the mean over
    the rest."""
    from repro_torch.launch import steps

    real = steps.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def broken(params, opt, batch):
            half = batch["tokens"].shape[0] // 2
            return step(params, opt, {k: v[:half] for k, v in batch.items()})
        return broken
    return _patched(steps, "make_train_step", make)


def frozen():
    """The train step returns its state unchanged (its loss still
    computed)."""
    from repro_torch.launch import steps
    from repro_torch.models import lm

    import torch

    def make(cfg, *a, **kw):
        def broken(params, opt, batch):
            with torch.no_grad():
                loss = lm.loss_fn(params, cfg, batch)
            return params, opt, {"loss": loss, "gnorm": loss * 0}
        return broken
    return _patched(steps, "make_train_step", make)


def no_bias_correction():
    """AdamW's update without its bias corrections (the moments are
    kept as they should be, so the first gradient reads right)."""
    from repro_torch.launch import steps

    real = steps.adamw_update

    def broken(params, grads, state, **kw):
        # at step 10^6 and more, 1 - b**t is 1 in f32
        params, new, gnorm = real(params, grads,
                                  state._replace(step=state.step + 10 ** 6),
                                  **kw)
        return params, new._replace(step=state.step + 1), gnorm
    return _patched(steps, "adamw_update", broken)


def altered_token():
    """The executor's answers each have their first token changed."""
    from repro_torch.launch.serve import DecodeExecutor

    real = DecodeExecutor.__call__

    def broken(self, reqs):
        outs = real(self, reqs)
        for o in outs:
            if len(o):
                o[0] = (int(o[0]) + 1) % self.cfg.vocab
        return outs
    return _patched(DecodeExecutor, "__call__", broken)


FAULTS = {"half_batch": half_batch, "frozen": frozen,
          "no_bias_correction": no_bias_correction,
          "altered_token": altered_token}
