"""One optimizer step of a model, as ``paddle_tpu/jit/train_step.py``
``TrainStep.__call__``, run eagerly: zero the grads, ``loss_fn(model,
*batch)``, backward, then ``optimizer.step()`` (the grad clip, the
update of every parameter, the step count).  Returns the loss, detached
(with ``has_aux``, ``(loss, aux)``).

With a ``scaler`` (``amp.GradScaler``, enabled) the step follows
``train_step.py:299-370``: the loss times the scale goes backward; every
gradient is unscaled in f32 and rounded back to its dtype; where any of
them is not finite the parameters and the optimizer's state keep their
values (the step still counts, and BatchNorm's running buffers, which
the forward updated, keep their update, as JAX's ``new_buffers``); then
the scale and the counters move.  The scale, the counters and the
overflow flag stay on the device: no step reads them on the host.

``many(batches)`` runs K steps over K equal-shape batches and returns
their losses as one ``[K]`` tensor, JAX's contract
(``train_step.py:428-533``).  JAX scans one compiled program over the K
steps; here they are K eager steps, so an RNG-free pack equals K
sequential calls bit for bit (and so does one that draws: the port's
counter stream gives the K steps their sequential keys, where JAX's
splits one key).  Nothing in a step moves the learning-rate schedule,
so the pack reads one rate, as JAX's reads it once.

The JAX step is one jitted XLA program; PyTorch runs eagerly, and the
hand-written kernels carry the attention and norms.  Not ported yet
(TPU/XLA machinery, each named in ROADMAP.md): AUTO layouts, the update
barrier, a pack captured as one program (a CUDA graph of the steps).
The grads are dropped after the update, as the JAX step keeps none.
"""

from __future__ import annotations

import torch

from ..device import resolve_device


def _detach(x):
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, (tuple, list)):
        return type(x)(_detach(v) for v in x)
    if isinstance(x, dict):
        return {k: _detach(v) for k, v in x.items()}
    return x


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, scaler=None, has_aux=False,
                 device=None):
        """``loss_fn(model, *batch) -> scalar loss`` (with ``has_aux``,
        ``-> (loss, aux)``, aux a tensor or a tuple, list or dict of
        them).  The model, the optimizer and the scaler must live on
        ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""
        self.device = resolve_device(device)
        self.scaler = (scaler if scaler is not None and scaler.is_enable()
                       else None)
        owners = [("model", next(model.parameters()).device),
                  ("optimizer", optimizer.device)]
        if self.scaler is not None:
            owners.append(("scaler", self.scaler.device))
        for what, dev in owners:
            if dev != self.device:
                raise ValueError(f"{what} lives on {dev}, the step on "
                                 f"{self.device}")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.has_aux = has_aux

    def many(self, batches):
        """K steps, one a batch of ``batches`` (K batch tuples, or single
        tensors, of equal shapes); returns the K losses as a ``[K]``
        tensor.  Raises with ``has_aux`` (each step's aux would have to be
        stacked) and on an empty or ragged pack."""
        if not batches:
            raise ValueError("many() expects at least one batch")
        if self.has_aux:
            raise ValueError("many() does not support has_aux steps (the "
                             "per-step aux would be K-stacked; run "
                             "__call__ per step instead)")
        tuples = [b if isinstance(b, (tuple, list)) else (b,)
                  for b in batches]
        shapes = [[tuple(getattr(x, "shape", ())) for x in b]
                  for b in tuples]
        if any(s != shapes[0] for s in shapes):
            raise ValueError(f"many() expects equal-shape batches, got "
                             f"{shapes}")
        return torch.stack([self(*b) for b in tuples])

    def __call__(self, *batch):
        opt = self.optimizer
        opt.clear_grad()
        res = self.loss_fn(self.model, *batch)
        loss, aux = res if self.has_aux else (res, None)
        if self.scaler is None:
            loss.backward()
            opt.step()
        else:
            (loss * self.scaler.get_loss_scaling()).backward()
            found_inf = self.scaler.unscale_grads(self.model.parameters())
            opt.step(skip=found_inf)
            self.scaler._advance(found_inf)
        opt.clear_grad()
        if self.has_aux:
            return loss.detach(), _detach(aux)
        return loss.detach()
