"""``LBFGS``, the counterpart of ``paddle_tpu/optimizer/lbfgs.py``, term
for term.

Closure-driven quasi-Newton: ``step(closure)`` calls ``closure()`` (which
recomputes the loss and calls ``backward()``) as often as it needs.  The
(s, y) history lives in Python lists of flat f32 vectors on the
optimizer's device; the direction is the two-loop recursion over it,
scaled by ``s.y / y.y`` of the newest pair; ``line_search_fn=
"strong_wolfe"`` halves the step from the learning rate until the Armijo
and curvature conditions hold (at most 20 tries).  The scalar tests read
each value on the host, as the JAX optimizer's ``float(...)`` does.
Weight decay and ``grad_clip`` are accepted and unused, as in JAX.
"""

from __future__ import annotations

import torch

from .optimizer import Optimizer


class LBFGS(Optimizer):
    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._max_iter = max_iter
        self._max_eval = max_eval or max_iter * 5 // 4
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history = history_size
        self._line_search = line_search_fn
        self._s, self._y = [], []

    # ---- flat vector helpers ----------------------------------------
    def _params(self):
        return [p for p in self._parameter_list if p.requires_grad]

    @staticmethod
    def _flat(tensors):
        return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])

    def _flat_params(self):
        return self._flat([p.detach() for p in self._params()])

    def _flat_grads(self):
        return self._flat([p.grad if p.grad is not None
                           else torch.zeros_like(p) for p in self._params()])

    def _assign(self, flat):
        off = 0
        with torch.no_grad():
            for p in self._params():
                n = p.numel()
                p.copy_(flat[off:off + n].reshape(p.shape).to(p.dtype))
                off += n

    def _direction(self, g):
        """Two-loop recursion over the stored (s, y) pairs."""
        q = -g
        alphas = []
        for s, y in reversed(list(zip(self._s, self._y))):
            rho = 1.0 / torch.clamp(torch.dot(y, s), min=1e-10)
            a = rho * torch.dot(s, q)
            alphas.append((a, rho, s, y))
            q = q - a * y
        if self._s:
            s, y = self._s[-1], self._y[-1]
            q = q * (torch.dot(s, y) / torch.clamp(torch.dot(y, y),
                                                   min=1e-10))
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + s * (a - b)
        return q

    def _eval(self, closure):
        for p in self._params():
            p.grad = None
        with torch.enable_grad():
            loss = closure()
        return float(loss.detach()), self._flat_grads()

    def step(self, closure=None):
        """Up to ``max_iter`` iterations (``max_eval`` closure calls) from
        the current parameters; returns the last loss as a 0-d tensor."""
        if closure is None:
            raise ValueError("LBFGS.step requires a closure that recomputes "
                             "the loss and calls backward()")
        lr = self.get_lr()
        loss, g = self._eval(closure)
        evals = 1
        for _ in range(self._max_iter):
            if float(g.abs().max()) <= self._tol_grad:
                break
            d = self._direction(g)
            x0 = self._flat_params()
            gtd = float(torch.dot(g, d))
            if gtd > -1e-15:  # not a descent direction: reset history
                self._s, self._y = [], []
                d = -g
                gtd = float(torch.dot(g, d))
            t = lr
            if self._line_search == "strong_wolfe":
                c1, c2 = 1e-4, 0.9
                ok = False
                for _ls in range(20):
                    self._assign(x0 + t * d)
                    new_loss, new_g = self._eval(closure)
                    evals += 1
                    if new_loss <= loss + c1 * t * gtd and \
                            abs(float(torch.dot(new_g, d))) <= -c2 * gtd:
                        ok = True
                        break
                    t *= 0.5
                    if evals >= self._max_eval:
                        break
                if not ok:
                    self._assign(x0 + t * d)
                    new_loss, new_g = self._eval(closure)
                    evals += 1
            else:
                self._assign(x0 + t * d)
                new_loss, new_g = self._eval(closure)
                evals += 1
            s = t * d
            yv = new_g - g
            if float(torch.dot(s, yv)) > 1e-10:
                self._s.append(s)
                self._y.append(yv)
                if len(self._s) > self._history:
                    self._s.pop(0)
                    self._y.pop(0)
            if abs(new_loss - loss) < self._tol_change:
                loss, g = new_loss, new_g
                break
            loss, g = new_loss, new_g
            if evals >= self._max_eval:
                break
        self._step_count += 1
        return torch.tensor(loss, device=self.device)
