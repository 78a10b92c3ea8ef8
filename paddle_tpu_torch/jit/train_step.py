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
steps; on the card the K steps are one CUDA graph per (batch signature,
K): the first pack of a signature runs its K steps eagerly (the warm-up:
every lazy allocation, plan and kernel load happens there), then the K
steps are captured once (on a stream of this step's own, whose norm
backward ticket is allocated before the capture), and every later pack
copies its batches into the graph's static inputs, writes the learning
rate once (``Optimizer._fill_lrs``) and replays.  The optimizer's and
the scaler's state are tensors that every step and every setter
(``set_state_dict``, ``set_init_loss_scaling``, ``load_state_dict``)
write in place, so a replay reads what the host set last.  An RNG-free
pack so equals K sequential calls bit for bit.  Each step of a captured pack
draws from a generator registered with the graph, whose offset advances
on every replay, so dropout masks differ from step to step and from pack
to pack (eager steps keep the stream's sequential keys).  A replay runs
no Python, so the kernels' launch counters are advanced by the launches
the capture recorded, once per replay.  The host state the capture
touched (the step count, the stream's counter, the launch counters) is
restored after it.  A capture that fails raises; nothing gives way to
eager steps after the first pack.  On the CPU ``many`` is K eager steps.

The JAX step is one jitted XLA program; PyTorch runs eagerly, and the
hand-written kernels carry the attention and norms.  Not ported (TPU/XLA
machinery, each named in ROADMAP.md): AUTO layouts, the update barrier.
The grads are dropped after the update, as the JAX step keeps none.
"""

from __future__ import annotations

import torch

from .. import random as _random
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
        self._packs = {}          # (K, batch signature) -> captured pack
        self._stream = None       # the capture stream (CUDA)

    def many(self, batches):
        """K steps, one a batch of ``batches`` (K batch tuples, or single
        tensors, of equal shapes); returns the K losses as a ``[K]``
        tensor (on the card one CUDA graph replay per pack after the
        first of its signature: the module docstring).  Raises with
        ``has_aux`` (each step's aux would have to be stacked) and on an
        empty or ragged pack."""
        if not batches:
            raise ValueError("many() expects at least one batch")
        if self.has_aux:
            raise ValueError("many() does not support has_aux steps (the "
                             "per-step aux would be K-stacked; run "
                             "__call__ per step instead)")
        tuples = [tuple(b) if isinstance(b, (tuple, list)) else (b,)
                  for b in batches]
        shapes = [[tuple(getattr(x, "shape", ())) for x in b]
                  for b in tuples]
        if any(s != shapes[0] for s in shapes):
            raise ValueError(f"many() expects equal-shape batches, got "
                             f"{shapes}")
        if self.device.type != "cuda":
            return torch.stack([self(*b) for b in tuples])
        key = (len(tuples), tuple(
            (tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor)
            else ("S", repr(x)) for x in tuples[0]))
        pack = self._packs.get(key)
        if pack is None:
            losses = torch.stack([self(*b) for b in tuples])
            self._packs[key] = self._capture(tuples)
            return losses
        return self._replay(pack, tuples)

    def _capture(self, tuples):
        """Record the K steps of ``tuples`` as one CUDA graph over static
        copies of the batches (see the module docstring)."""
        from .. import _build
        from ..ops import kernel_launches

        dev = self.device
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        static = [tuple(x.clone() if isinstance(x, torch.Tensor) else x
                        for x in b) for b in tuples]
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        # the norm backwards' ticket of the capture stream, allocated and
        # zeroed now (its kernels leave it at 0 again on every replay)
        _build.ticket(dev, self._stream.cuda_stream)
        gen = torch.Generator(device=dev)
        gen.manual_seed(_random.key_seed(*_random.next_key()))
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        steps = self.optimizer._step_count
        rng = _random.get_rng_state()
        before = kernel_launches()
        torch.cuda.synchronize(dev)
        try:
            with _random.graph_generator(gen), \
                    torch.cuda.graph(graph, stream=self._stream):
                losses = torch.stack([self(*b) for b in static])
        finally:
            captured = {k: v - before[k] for k, v in kernel_launches().items()}
            _restore_launches(before)
            self.optimizer._step_count = steps
            _random.set_rng_state(rng)
        return {"graph": graph, "static": static, "losses": losses,
                "launches": captured}

    def _replay(self, pack, tuples):
        for dst, src in zip(pack["static"], tuples):
            for d, x in zip(dst, src):
                if isinstance(d, torch.Tensor):
                    d.copy_(x)
        self.optimizer._fill_lrs()
        pack["graph"].replay()
        self.optimizer._step_count += len(tuples)
        _add_launches(pack["launches"])
        return pack["losses"].clone()

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


def _restore_launches(counts):
    from ..ops import _counters

    for name, fn in _counters().items():
        fn.launches = counts[name]


def _add_launches(delta):
    from ..ops import _counters

    for name, fn in _counters().items():
        fn.launches += delta[name]
