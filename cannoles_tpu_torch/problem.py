"""Problem protocol: equality-constrained nonlinear least squares, batched.

PyTorch counterpart of ``cannoles_tpu/problem.py``.  The user supplies pure
functions on ONE instance,

    residual(x[, data]) -> (nequ,)   and   cons(x[, data]) -> (ncon,)

written with torch ops, and every evaluator below works on a batch: ``x`` is
(B, nvar) and ``data`` is ``None`` or a pytree (tensor, dict, tuple) whose
leaves carry the same leading B axis.  Values are batched with
``torch.func.vmap`` over ``(x, data)``, and at B = 1 the function is called
on the one instance; derivatives come from ``torch.func.jacfwd`` and, for the
weighted Hessians Σᵢ wᵢ∇²Fᵢ, ``torch.func.hessian``.  Each evaluator builds
its callable once per problem.  On the CPU a B = 1 derivative is traced at
its ``TRACE_CALLS``-th call with one input layout (``_Trace``).  The matrix-free products (``jprod_res``, ``jtprod_res``,
``jprod_cons``, ``jtprod_cons``, ``hprod_res``, ``hprod_cons``,
``hprod_lag``) are one ``torch.func.jvp``, ``vjp`` or forward-over-reverse
pass each, batched the same way; they never form a Jacobian.  The shard_map
basis of the JAX package has no counterpart.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, jvp, vjp, vmap

__all__ = ["NLSProblem", "nls_problem", "default_device", "Counters", "TRACE_CALLS"]

# the call of a B = 1 derivative evaluator on the CPU (a ``torch.func``
# transform of the residual or the constraints), with one input layout, at
# which it is traced (``_Trace``): recording one costs as much as a median of
# 48 of its eager calls over the battery's problems (``host_timings --what
# trace``), so a solve that calls it more often pays at most about twice the
# least it could, and a short one never records.  Values (``F``, ``c``) and
# the user's own derivatives are not traced: a trace of plain operations
# gains nothing
TRACE_CALLS = 48
# the evaluators built from transforms (``_apply``'s keys)
_TRACED = frozenset({"Jfwd", "FJfwd", "Jcfwd", "Hres_ad", "Hcon_ad"})


class Counters:
    """Evaluation counters, mirroring NLPModels NLSCounters."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.neval_residual = 0
        self.neval_cons = 0
        self.neval_jac_residual = 0
        self.neval_jac = 0
        self.neval_hess_residual = 0
        self.neval_hess = 0

    def eval_fun(self) -> int:
        return self.neval_residual + self.neval_cons


def _wants_data(fn: Callable) -> bool:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return len(sig.parameters) >= 2


def _as_dtype(J, x):
    """A forward-mode Jacobian in ``x``'s dtype.  PyTorch's forward-mode
    formulas turn a Python float that meets a 0-d tensor (``x[0] - 0.5``,
    ``2.5 * x[1]``) into a float64 tensor, so a float32 residual can come
    back with a float64 Jacobian; its entries are cast back (a no-op when
    the dtypes already agree)."""
    return J.to(x.dtype)


def _dd(data):
    """vmap in_dim of a data argument: batched leaves, or nothing to map."""
    return None if data is None else 0


@dataclasses.dataclass(frozen=True)
class NLSProblem:
    """min ½‖residual(x)‖²  s.t.  cons(x) = lcon  (= ucon), no bounds."""

    residual: Callable  # (x, data) -> (nequ,)
    nvar: int
    nequ: int
    x0: Any  # (nvar,) tensor
    cons: Optional[Callable] = None  # (x, data) -> (ncon,)
    ncon: int = 0
    lcon: Any = None
    ucon: Any = None
    y0: Any = None
    lvar: Any = None
    uvar: Any = None
    data: Any = None
    name: str = "generic"
    minimize: bool = True
    has_residual_hessian: bool = True
    jac_residual: Optional[Callable] = None
    hess_residual_weighted: Optional[Callable] = None  # (x, r, data) -> (n, n)
    jac_cons: Optional[Callable] = None
    hess_cons_weighted: Optional[Callable] = None  # (x, y, data) -> (n, n)
    counters: Counters = dataclasses.field(default_factory=Counters, compare=False)
    # the evaluators' torch.func callables, built on first use (``_fn``)
    _fns: dict = dataclasses.field(default_factory=dict, init=False, compare=False, repr=False)
    # the CPU's B = 1 callables by (evaluator, input layout): calls so far,
    # then their ``_Trace``, or why the trace failed (``untraced``)
    _traces: dict = dataclasses.field(default_factory=dict, init=False, compare=False, repr=False)

    # ---- validation ----
    def validate_for_solve(self):
        if not self.minimize:
            raise ValueError("CaNNOLeS only works for minimization problem")
        if self.has_inequalities() or self.has_bounds():
            raise ValueError("Problem has inequalities, can't solve it")

    def has_bounds(self) -> bool:
        if self.lvar is None and self.uvar is None:
            return False
        lv = np.asarray(self.lvar) if self.lvar is not None else np.full(self.nvar, -np.inf)
        uv = np.asarray(self.uvar) if self.uvar is not None else np.full(self.nvar, np.inf)
        return bool(np.any(np.isfinite(lv)) or np.any(np.isfinite(uv)))

    def has_inequalities(self) -> bool:
        if self.ncon == 0:
            return False
        return bool(torch.any(self.lcon != self.ucon))

    # ---- batched evaluators: x (B, n), data leaves (B, ...) or None ----
    # Each builds its torch.func callable once per problem (``_fn``).  At
    # B = 1 it calls the unbatched function on lane 0 and adds the axis
    # back: the same arithmetic without vmap's cost per call.
    def _fn(self, key, build):
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = build()
        return fn

    def _apply(self, key, build, x, *args, data=None):
        """``build()`` is a function of one instance, ``f(x, *args, data)``;
        this maps it over the leading axis of ``x``, ``args`` and ``data``."""
        one = self._fn(key, build)
        if x.shape[0] == 1:
            args0 = (x[0], *[a[0] for a in args], _lane0(data))
            out = self._call_one(key, one, args0) if key in _TRACED else one(*args0)
            return tuple(o.unsqueeze(0) for o in out) if isinstance(out, tuple) else out.unsqueeze(0)
        mapped = self._fn((key, data is None), lambda: vmap(one, in_dims=(0,) * (1 + len(args)) + (_dd(data),)))
        return mapped(x, *args, data)

    def _call_one(self, key, one, args):
        """``one(*args)`` on one instance (a derivative); on the CPU through
        its trace from its ``TRACE_CALLS``-th call with this input layout."""
        leaves = _tensors(args, [])
        if leaves[0].device.type != "cpu" or any(
            torch._C._functorch.is_functorch_wrapped_tensor(t) or (t.requires_grad and torch.is_grad_enabled())
            for t in leaves
        ):
            return one(*args)
        tkey = (key, _layout(args))
        ent = self._traces.get(tkey, 0)
        if isinstance(ent, int):
            if ent + 1 < TRACE_CALLS:
                self._traces[tkey] = ent + 1
                return one(*args)
            try:
                ent = _Trace(one, args)
            except Exception as e:  # noqa: BLE001 - the callable stays eager, recorded
                ent = f"{type(e).__name__}: {e}"
            self._traces[tkey] = ent
        return one(*args) if isinstance(ent, str) else ent(leaves)

    @property
    def untraced(self) -> dict:
        """The B = 1 callables whose trace failed on the CPU, by (evaluator,
        input layout), with the error: they run eagerly."""
        return {k: v for k, v in self._traces.items() if isinstance(v, str)}

    def F(self, x, data=None):
        return self._apply("F", lambda: self.residual, x, data=data)

    def c_shifted(self, x, data=None):
        """cons(x) - lcon, (B, ncon)."""
        if self.ncon == 0:
            return x.new_zeros((x.shape[0], 0))
        c = self._apply("c", lambda: self.cons, x, data=data)
        return c - self.lcon.to(dtype=x.dtype, device=x.device)

    def Jt(self, x, data=None):
        """Jᵀ in its (B, nvar, nequ) layout, the one the solver state carries."""
        if self.jac_residual is not None:
            J = self._apply("J", lambda: self.jac_residual, x, data=data)
        else:
            J = _as_dtype(self._apply("Jfwd", lambda: jacfwd(self.residual), x, data=data), x)
        return J.transpose(-2, -1)

    def J(self, x, data=None):
        """(B, nequ, nvar) residual Jacobian."""
        return self.Jt(x, data).transpose(-2, -1)

    def F_and_J(self, x, data=None):
        """(F(x), J) from one forward-mode pass (``F_and_Jt``)."""
        Fx, JxT = self.F_and_Jt(x, data)
        return Fx, JxT.transpose(-2, -1)

    def F_and_Jt(self, x, data=None):
        """(F(x), Jᵀ) from one forward-mode pass (the residual is evaluated
        once, as the JAX package's linearize does)."""
        if self.jac_residual is not None:
            return self.F(x, data), self.Jt(x, data)

        def build():
            def fa(z, d):
                y = self.residual(z, d)
                return y, y

            return jacfwd(fa, has_aux=True)

        J, Fx = self._apply("FJfwd", build, x, data=data)
        return Fx, _as_dtype(J, x).transpose(-2, -1)

    def Jc(self, x, data=None):
        """(B, ncon, nvar) constraint Jacobian."""
        if self.ncon == 0:
            return x.new_zeros((x.shape[0], 0, self.nvar))
        if self.jac_cons is not None:
            return self._apply("Jc", lambda: self.jac_cons, x, data=data)
        return _as_dtype(self._apply("Jcfwd", lambda: jacfwd(self.cons), x, data=data), x)

    def hess_res(self, x, r, data=None):
        """Σᵢ rᵢ ∇²Fᵢ(x), (B, n, n)."""
        if not self.has_residual_hessian:
            raise NotImplementedError(
                f"problem '{self.name}' provides no residual Hessian; "
                "use method='gauss_newton' (reference :Newton_noFHess)"
            )
        if self.hess_residual_weighted is not None:
            return self._apply("Hres", lambda: self.hess_residual_weighted, x, r, data=data)
        return self._apply("Hres_ad", lambda: _weighted_hessian(self.residual), x, r, data=data)

    def hess_cons(self, x, y, data=None):
        """Σᵢ yᵢ ∇²cᵢ(x), (B, n, n) (NLPModels hess with obj_weight = 0)."""
        if self.ncon == 0:
            return x.new_zeros((x.shape[0], self.nvar, self.nvar))
        if self.hess_cons_weighted is not None:
            return self._apply("Hcon", lambda: self.hess_cons_weighted, x, y, data=data)
        return self._apply("Hcon_ad", lambda: _weighted_hessian(self.cons), x, y, data=data)

    # ---- matrix-free products (NLPModels jprod/jtprod/hprod parity) ----
    # x (B, nvar); v, w, r, y carry the same batch axis; no Jacobian is
    # formed.  Each vmapped callable is built once per problem.
    def _mapped(self, key, one, nargs, data):
        return self._fn(("mf", key, data is None), lambda: vmap(one(), in_dims=(0,) * nargs + (_dd(data),)))

    def jprod_res(self, x, v, data=None):
        """J(x) v, (B, nequ): one forward-mode pass (jprod_residual!)."""

        def one():
            return lambda z, u, d: jvp(lambda zz: self.residual(zz, d), (z,), (u,))[1]

        return self._mapped("jprod_res", one, 2, data)(x, v, data)

    def jtprod_res(self, x, v, data=None):
        """J(x)ᵀ v, (B, nvar): one reverse-mode pass (jtprod_residual!)."""

        def one():
            return lambda z, w, d: vjp(lambda zz: self.residual(zz, d), z)[1](w)[0]

        return self._mapped("jtprod_res", one, 2, data)(x, v, data)

    def res_pullback(self, x, data=None):
        """w ↦ J(x)ᵀ w for repeated use at one x: one forward pass with its
        graph kept, then a backward pass per call (the same values as
        ``jtprod_res``)."""
        _, pull = vjp(lambda z: self.F(z, data), x)
        return lambda w: pull(w)[0]

    def jprod_cons(self, x, v, data=None):
        """Jc(x) v, (B, ncon) (jprod!)."""
        if self.ncon == 0:
            return x.new_zeros((x.shape[0], 0))

        def one():
            return lambda z, u, d: jvp(lambda zz: self.cons(zz, d), (z,), (u,))[1]

        return self._mapped("jprod_cons", one, 2, data)(x, v, data)

    def jtprod_cons(self, x, v, data=None):
        """Jc(x)ᵀ v, (B, nvar) (jtprod!)."""
        if self.ncon == 0:
            return torch.zeros_like(x)

        def one():
            return lambda z, w, d: vjp(lambda zz: self.cons(zz, d), z)[1](w)[0]

        return self._mapped("jtprod_cons", one, 2, data)(x, v, data)

    def hprod_res(self, x, r, v, data=None):
        """(Σᵢ rᵢ ∇²Fᵢ(x)) v, (B, nvar), forward over reverse (hprod_residual!)."""
        if not self.has_residual_hessian:
            raise NotImplementedError(
                f"problem '{self.name}' provides no residual Hessian; "
                "use method='gauss_newton' (reference :Newton_noFHess)"
            )

        def one():
            def h(z, w, u, d):
                g = grad(lambda zz: (self.residual(zz, d) * w).sum())
                return jvp(g, (z,), (u,))[1]

            return h

        return self._mapped("hprod_res", one, 3, data)(x, r, v, data)

    def hprod_cons(self, x, y, v, data=None):
        """(Σᵢ yᵢ ∇²cᵢ(x)) v, (B, nvar): hprod! with obj_weight = 0."""
        if self.ncon == 0:
            return torch.zeros_like(x)

        def one():
            def h(z, w, u, d):
                g = grad(lambda zz: (self.cons(zz, d) * w).sum())
                return jvp(g, (z,), (u,))[1]

            return h

        return self._mapped("hprod_cons", one, 3, data)(x, y, v, data)

    def hprod_lag(self, x, y, v, *, obj_weight=1.0, data=None):
        """∇²ₓₓ(σ·½‖F‖² + yᵀc) v, (B, nvar): the NLPModels hprod! contract,
        the Gauss–Newton term JᵀJv plus the residual and constraint
        curvature."""

        def one():
            def lag(z, w, d):
                F = self.residual(z, d)
                val = obj_weight * 0.5 * (F * F).sum()
                if self.ncon > 0:
                    val = val + (self.cons(z, d) * w).sum()
                return val

            return lambda z, w, u, d: jvp(grad(lambda zz: lag(zz, w, d)), (z,), (u,))[1]

        return self._mapped(("hprod_lag", float(obj_weight)), one, 3, data)(x, y, v, data)


def _weighted_hessian(fn):
    """z, w, d ↦ Σᵢ wᵢ ∇²fnᵢ(z), forward over reverse: the JAX package's
    ``hessian`` route, whose rounding the parity tests hold the port to
    (reverse over reverse is faster here but moves the last bits, and
    ``biggs_exp6_24``'s 902-iteration trajectory with them; PERF.md §6)."""
    return hessian(lambda z, w, d: (fn(z, d) * w).sum())


class _Trace:
    """A one-instance callable recorded as aten operations (``make_fx``,
    below ``torch.func``'s transforms) and replayed by the recorded
    ``GraphModule``'s generated code, without the transforms' Python
    (forward-mode AD runs Python reference decompositions).  Before the
    replay the graph drops what computes no output: the operations whose
    results nothing reads (the decompositions' shape checks on meta
    tensors) and ``alias`` (a view that its uses read as its input).  What
    is left are the same arithmetic operations in the same order, so the
    same bits.  A callable that reads a value on the host cannot be
    recorded (``make_fx`` raises)."""

    def __init__(self, one, args):
        from torch.fx.experimental.proxy_tensor import make_fx

        # one input per leaf, also where two leaves hold the same tensor (the
        # tracer would bind both to one input)
        seen: set = set()
        example = []
        for t in _tensors(args, []):
            example.append(t.clone() if id(t) in seen else t)
            seen.add(id(t))
        single = []

        def flat(*xs):
            out = one(*_refill(args, iter(xs)))
            single.append(not isinstance(out, tuple))
            return (out,) if single[-1] else tuple(out)

        gm = make_fx(flat)(*example)
        for node in list(gm.graph.nodes):
            if node.target is torch.ops.aten.alias.default:
                node.replace_all_uses_with(node.args[0])
                gm.graph.erase_node(node)
        gm.graph.eliminate_dead_code()
        gm.recompile()
        self.fn = gm.forward
        self.single = single[-1]

    def __call__(self, leaves):
        out = self.fn(*leaves)
        return out[0] if self.single else tuple(out)


def _tensors(tree, out: list) -> list:
    """Append the tensor leaves of a pytree (tuple, list, dict) to ``out``."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    return out


def _refill(tree, it):
    """``tree`` with its tensor leaves taken from ``it``, in ``_tensors``'s order."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _refill(v, it) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_refill(v, it) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_refill(v, it) for v in tree)
    return tree


def _layout(tree):
    """The structure, shapes and dtypes of a pytree, and its other leaves'
    values (a trace's key: they are constants in it)."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return tuple((k, _layout(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_layout(v) for v in tree)
    return repr(tree)


def _lane0(tree):
    """Lane 0 of a data pytree whose leaves carry the batch axis."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[0]
    if isinstance(tree, dict):
        return {k: _lane0(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_lane0(v) for v in tree)
    return tree[0]


def _as_tensor(v, dtype, device):
    if isinstance(v, torch.Tensor):
        return v.to(dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)


def default_device(device=None, like=None) -> torch.device:
    """Where the port's entry points place a problem: ``device`` when given;
    else ``like``'s CUDA device when ``like`` is a tensor on one; else the
    card.  Without a card it raises rather than fall back to the CPU."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor) and like.device.type == "cuda":
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; "
            "pass device=\"cpu\" to run on the CPU"
        )
    return torch.device("cuda")


def nls_problem(
    residual: Callable,
    x0,
    nequ: int,
    cons: Optional[Callable] = None,
    lcon=None,
    ucon=None,
    *,
    y0=None,
    lvar=None,
    uvar=None,
    data: Any = None,
    name: str = "generic",
    minimize: bool = True,
    has_residual_hessian: bool = True,
    dtype: Optional[torch.dtype] = None,
    device=None,
    **analytic,
) -> NLSProblem:
    """Build an :class:`NLSProblem` (the ADNLSModel analog).

    ``residual``/``cons`` take one argument ``f(x)`` or two ``f(x, data)``
    and act on ONE instance: ``x`` is (nvar,).  They are batched with
    ``torch.func.vmap``, so they must build their output vectors with
    ``torch.stack``/``torch.cat`` of tensor expressions; ``torch.tensor([...])``
    of tensor elements breaks under vmap.

    ``dtype``/``device`` place ``x0``, ``y0`` and ``lcon``/``ucon``.  The
    dtype follows ``x0`` when it is a tensor, else float64.  The device
    defaults to the card (an ``x0`` already on a CUDA device keeps it);
    without a card this raises unless ``device="cpu"`` is given.  ``data``
    is passed through as given.
    """
    if dtype is None:
        dtype = x0.dtype if isinstance(x0, torch.Tensor) else torch.float64
    device = default_device(device, x0)
    x0 = _as_tensor(x0, dtype, device).reshape(-1)
    nvar = int(x0.shape[0])

    def _lift(fn):
        if fn is None:
            return None
        if _wants_data(fn):
            return fn
        return lambda x, data, _fn=fn: _fn(x)

    res = _lift(residual)
    con = _lift(cons)

    ncon = 0
    if con is not None:
        if lcon is None:
            raise ValueError("constrained problem requires lcon (and ucon)")
        lcon = torch.atleast_1d(_as_tensor(lcon, dtype, device))
        ucon = torch.atleast_1d(_as_tensor(ucon, dtype, device)) if ucon is not None else lcon
        ncon = int(lcon.shape[0])
    y0 = x0.new_zeros((ncon,)) if y0 is None else _as_tensor(y0, dtype, device)

    return NLSProblem(
        residual=res,
        nvar=nvar,
        nequ=int(nequ),
        x0=x0,
        cons=con,
        ncon=ncon,
        lcon=lcon,
        ucon=ucon,
        y0=y0,
        lvar=lvar,
        uvar=uvar,
        data=data,
        name=name,
        minimize=minimize,
        has_residual_hessian=has_residual_hessian,
        jac_residual=_lift(analytic.get("jac_residual")),
        hess_residual_weighted=analytic.get("hess_residual_weighted"),
        jac_cons=_lift(analytic.get("jac_cons")),
        hess_cons_weighted=analytic.get("hess_cons_weighted"),
    )
