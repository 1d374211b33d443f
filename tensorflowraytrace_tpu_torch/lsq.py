"""Damped least squares (Levenberg-Marquardt): the classical lens optimizer.

Counterpart of ``tensorflowraytrace_tpu/lsq.py``.  Production lens-design
codes optimize a residual vector (per-ray transverse aberrations,
weighted first-order targets) by damped least squares: one damped
normal-equations solve an iteration captures the local curvature of a
small-parameter least-squares problem.

* The Jacobian is ``torch.func.jacfwd`` of the flat residual: P
  forward-mode passes, batched, over the same trace the residual runs.
* The normal equations are solved by a (P, P) Cholesky
  (``torch.linalg.cholesky_ex``).  The JAX package's solve returns NaN on
  a matrix that is not positive definite and then rejects the step; the
  port reads the factorisation's ``info`` and rejects the step the same
  way, through ``torch.where``, where ``torch.linalg.solve`` would raise.
* Accept and reject are branch-free and the iteration count is fixed:
  nothing is read back to the host inside the loop.

Parameters are nested tuples, lists and dicts of tensors (flattened with
the dict keys sorted, as ``jax.flatten_util.ravel_pytree`` does);
residuals may be any such tree.  Weight a residual row by scaling it.
The module is not exported from the package's ``__init__``, as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


def _leaves(tree):
    """The tensors of a nested tuple, list or dict (keys sorted) in order,
    and a function that rebuilds the tree from such a list."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_leaves(tree[k]) for k in keys]

        def build(leaves):
            out, i = {}, 0
            for k, (sub, rebuild) in zip(keys, parts):
                out[k] = rebuild(leaves[i:i + len(sub)])
                i += len(sub)
            return out
    elif isinstance(tree, (tuple, list)):
        parts = [_leaves(t) for t in tree]

        def build(leaves):
            out, i = [], 0
            for sub, rebuild in parts:
                out.append(rebuild(leaves[i:i + len(sub)]))
                i += len(sub)
            return type(tree)(out)
    else:
        return [torch.as_tensor(tree)], lambda leaves: leaves[0]
    return [leaf for sub, _ in parts for leaf in sub], build


def ravel(tree):
    """``(flat, unravel)``: the leaves of ``tree`` flattened into one
    vector (their common dtype), and the function that maps such a vector
    back to the tree, each leaf in its own shape and dtype."""
    leaves, build = _leaves(tree)
    shapes = [leaf.shape for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])

    def unravel(x):
        pieces = torch.split(x, sizes)
        return build([piece.reshape(shape).to(dtype)
                      for piece, shape, dtype in zip(pieces, shapes, dtypes)])

    return flat, unravel


@dataclass
class LMResult:
    """The outcome of :func:`lm_solve`.

    ``cost`` is ``0.5 * sum(r^2)`` (so the gradient is ``J^T r``).
    ``cost_history``/``accepted`` hold one entry an iteration (a rejected
    proposal repeats the previous cost).  ``grad_norm`` is ``|J^T r|`` at
    the solution, the first-order optimality measure."""

    params: Any
    cost: torch.Tensor
    residual: torch.Tensor
    damping: torch.Tensor
    cost_history: torch.Tensor
    accepted: torch.Tensor
    grad_norm: torch.Tensor


def lm_solve(residual_fn, params, *args, steps=30, init_damping=1e-3,
             damping_up=10.0, damping_dn=0.2, min_damping=1e-14,
             max_damping=1e14, marquardt=True):
    """Minimise ``0.5 * |residual_fn(params, *args)|^2`` by damped least
    squares.

    ``residual_fn(params, *args)`` maps a parameter tree to a tree of
    residual tensors (flattened to one (M,) vector); ``params`` is the
    starting point.  Each iteration solves the damped normal equations::

        (J^T J + lam * D) delta = -J^T r,    D = diag(J^T J)  (Marquardt)
                                             D = I             (Levenberg)

    accepting ``delta`` when the cost drops (damping times
    ``damping_dn``) and rejecting it otherwise (damping times
    ``damping_up``), Marquardt's schedule.  ``residual_fn`` must run under
    ``torch.func.jacfwd``: no in-place operation on its inputs and nothing
    read back to the host.

    Marquardt scaling (the default) normalises each Jacobian column to
    unit norm before forming the normal equations (MINPACK's form), so the
    step does not depend on the variables' units; a floor keeps an
    exactly insensitive variable (a zero column) solvable.  Pass
    ``marquardt=False`` for plain Levenberg.

    Returns an :class:`LMResult`.
    """
    x0, unravel = ravel(params)
    dtype = x0.dtype

    def rvec(x):
        r, _ = ravel(residual_fn(unravel(x), *args))
        return r.to(dtype)

    jac = torch.func.jacfwd(rvec)
    eps = torch.finfo(dtype).eps
    eye = torch.eye(x0.shape[0], dtype=dtype, device=x0.device)

    x, r = x0, rvec(x0)
    cost = 0.5 * torch.dot(r, r)
    lam = torch.as_tensor(init_damping, dtype=dtype, device=x0.device)
    hist, acc = [], []
    for _ in range(steps):
        jm = jac(x)
        if marquardt:
            col = torch.sqrt(torch.sum(jm * jm, dim=0))
            s = torch.maximum(col, torch.clamp(torch.max(col), min=1.0) * eps)
        else:
            s = torch.ones_like(x)
        js = jm / s[None, :]
        a = js.T @ js + lam * eye
        chol, info = torch.linalg.cholesky_ex(a)
        solved = info == 0
        delta = torch.cholesky_solve(-(js.T @ r)[:, None], chol)[:, 0] / s
        # a matrix that is not positive definite is a rejected proposal
        x_new = x + torch.where(solved, delta, torch.zeros_like(delta))
        r_new = rvec(x_new)
        new_cost = 0.5 * torch.dot(r_new, r_new)
        accept = solved & torch.isfinite(new_cost) & (new_cost < cost)
        x = torch.where(accept, x_new, x)
        r = torch.where(accept, r_new, r)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * damping_dn,
                                      lam * damping_up),
                          min=min_damping, max=max_damping)
        hist.append(cost)
        acc.append(accept)
    grad_norm = torch.linalg.norm(jac(x).T @ r)
    none = x0.new_zeros((0,))
    return LMResult(params=unravel(x), cost=cost, residual=r, damping=lam,
                    cost_history=torch.stack(hist) if hist else none,
                    accepted=torch.stack(acc) if acc else none.bool(),
                    grad_norm=grad_norm)
