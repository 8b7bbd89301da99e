"""PyTorch port on a CUDA card: the fused LDLᵀ kernel and the two blocked
Cholesky kernels against their plain versions, the wrappers' input checks,
and the solver on the card against the solver on the CPU.

Every test here is marked ``gpu`` and skips without a card.  The file
imports no JAX (the machine with the card has none), so on the card it runs
without the JAX-only ``conftest.py``:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cannoles_tpu_torch import CaNNOLeSSolver, vsolve  # noqa: E402
from cannoles_tpu_torch.core import segments  # noqa: E402
from cannoles_tpu_torch.models.ba_large import large_bundle_adjustment  # noqa: E402
from cannoles_tpu_torch.models.families import lm_bench_batch, lm_bench_family  # noqa: E402
from cannoles_tpu_torch.ops import block_chol as tchol  # noqa: E402
from cannoles_tpu_torch.ops import fused_ldlt as tfused  # noqa: E402
from cannoles_tpu_torch.utils.testing import quasi_definite  # noqa: E402

pytestmark = pytest.mark.gpu


def _n(key):
    """The process's count ``key`` (``core.segments.counters()``)."""
    return segments.counters().get(key, 0)


def _by_shape():
    """The fused LDLT kernel's launches by (N, B)."""
    return {k[1]: n for k, n in segments.counters().items() if isinstance(k, tuple) and k[0] == "fused_ldlt"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card: "
                    "python -m pytest --noconftest -m gpu tests/test_torch_gpu.py")
    return torch.device("cuda", 0)


def _fused_shapes(dt):
    """(N, B) over both mappings: one thread per system up to
    ``thread_max_n()``, one block per system above it (its 8 x 8 team up to
    N = 96, 16 x 16 above), up to the cap."""
    t = tfused.thread_max_n()
    return [(1, 3), (5, 257), (t, 257), (t + 1, 257), (34, 3), (73, 257), (96, 3), (97, 3),
            (tfused.max_n(dt), 3)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_kernel_matches_plain_on_card(cuda, dtype):
    # float64 to 1e-12 relative; float32 to 1e-4: the elimination is the
    # plain version's operation for operation (--fmad=false), only the
    # backward substitution sums in another order
    dt = getattr(torch, dtype)
    tol = float(torch.finfo(dt).eps)
    rel = 1e-12 if dt == torch.float64 else 1e-4
    for N, B in _fused_shapes(dt):
        W, rhs, n1 = quasi_definite(B, N, seed=N)
        Wc = torch.as_tensor(W, dtype=dt, device=cuda)
        rc = torch.as_tensor(rhs, dtype=dt, device=cuda)
        before = _n("fused_ldlt")
        x, d = tfused.fused_ldlt_solve(Wc, rc, tol)
        torch.cuda.synchronize()
        assert _n("fused_ldlt") == before + 1
        xr, dr = tfused.fused_ldlt_solve_reference(Wc, rc, tol)
        assert float((d - dr).abs().max()) <= rel * float(dr.abs().max())
        assert float((x - xr).abs().max()) <= rel * float(xr.abs().max())
        assert torch.equal(d > tol, dr > tol) and torch.equal(d.abs() <= tol, dr.abs() <= tol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_kernel_bit_equal_to_plain_on_card(cuda, dtype):
    """The raw pivots d are the plain version's bit for bit on both
    mappings, on both sides of the threshold, at the cap and at B not a
    multiple of a block's systems; every forced route too (the upper
    triangle, updates in ascending k, --fmad=false)."""
    dt = getattr(torch, dtype)
    tol = float(torch.finfo(dt).eps)
    t = tfused.thread_max_n()
    for N in sorted({N for N, _ in _fused_shapes(dt)}):
        for B in (1, 3, 257):
            W, rhs, _ = quasi_definite(B, N, seed=N + B)
            Wc = torch.as_tensor(W, dtype=dt, device=cuda)
            rc = torch.as_tensor(rhs, dtype=dt, device=cuda)
            _, dr = tfused.fused_ldlt_solve_reference(Wc, rc, tol)
            # every forced route at N = 5, and those whose shared memory
            # holds N = thread_max_n() in float64 too (128 systems do not)
            routes = [0] + ([32, 64, 128, -1] if N == 5 else [32, 64, -1] if N == t else [])
            for route in routes:
                _, d = tfused._launch(Wc, rc, tol, route)
                torch.cuda.synchronize()
                assert torch.equal(d, dr), (N, B, route)


def test_fused_kernel_rejects_what_it_does_not_take(cuda):
    W, rhs, _ = quasi_definite(4, 5, seed=0)
    Wc, rc = torch.as_tensor(W, device=cuda), torch.as_tensor(rhs, device=cuda)
    before = _n("fused_ldlt")
    with pytest.raises(ValueError):
        tfused.fused_ldlt_solve(Wc[:, :, :4], rc, 1e-16)  # not square
    with pytest.raises(ValueError):
        tfused.fused_ldlt_solve(Wc.transpose(1, 2), rc, 1e-16)  # not contiguous
    with pytest.raises(ValueError):
        tfused.fused_ldlt_solve(Wc, rc.cpu(), 1e-16)  # two devices
    with pytest.raises(TypeError):
        tfused.fused_ldlt_solve(Wc.half(), rc.half(), 1e-3)
    N = tfused.max_n(torch.float64) + 1
    with pytest.raises(ValueError, match="cap"):
        tfused.fused_ldlt_solve(torch.eye(N, dtype=torch.float64, device=cuda)[None],
                                torch.ones((1, N), dtype=torch.float64, device=cuda), 1e-16)
    assert _n("fused_ldlt") == before


def test_vsolve_on_card_matches_cpu(cuda):
    """The bench family in float64 through vsolve with the rescue: per-lane
    status and counters equal on the card (kernel) and the CPU (plain
    version), solutions within 1e-10."""
    x0, d = lm_bench_batch(32, seed=3)
    out = {}
    for where in (cuda, torch.device("cpu")):
        pb = lm_bench_family(torch.float64, where)
        s = CaNNOLeSSolver(pb, method="lm", linsolve="pallas", kkt="full")
        before = _n("fused_ldlt")
        out[where.type] = vsolve(pb, x0, data_batch=d, solver=s, max_iter=50, rescue=True)
        assert (_n("fused_ldlt") > before) == (where.type == "cuda")
    g, c = out["cuda"], out["cpu"]
    for f in ("status", "iter", "nfact", "nbk", "nlinsolve", "msg", "neval_F", "neval_c"):
        assert torch.equal(getattr(g.states, f).cpu(), getattr(c.states, f)), f
    np.testing.assert_allclose(g.solution, c.solution, rtol=0, atol=1e-10)
    assert g.solved_mask().all()


def _spd_batch(B, N, seed, dtype, device):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, N, N))
    A = G @ G.transpose(0, 2, 1) + N * np.eye(N)
    return torch.as_tensor(A, dtype=dtype, device=device)


def _ill_conditioned(B, N, seed, dtype, device):
    """SPD with κ = 1e6: N·Q diag(geomspace(1, 1e-6)) Qᵀ, Q orthogonal."""
    Q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(B, N, N)))
    A = (Q * np.geomspace(1.0, 1e-6, N)) @ Q.transpose(0, 2, 1) * N
    return torch.as_tensor(0.5 * (A + A.transpose(0, 2, 1)), dtype=dtype, device=device)


@pytest.mark.parametrize("ill", [False, True], ids=["kappa10", "kappa1e6"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("nb", [128, 256, 512])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chol_kernels_match_plain_on_card(cuda, dtype, nb, B, ill):
    # float64 to 1e-12 relative, float32 to 1e-4: a block's elimination is
    # the plain version's operation for operation (--fmad=false); across
    # blocks the plain version forms L21 and the trailing update with
    # torch.matmul, the kernel by substitution and its own tiles.  At κ = 1e6
    # L and d keep these bars; L⁻¹, whose rounding is amplified by
    # κ(L) = 1e3, is held at about 10× its worst reading over these shapes
    # on an H100 (4.56e-3 f32, 7.71e-12 f64).
    dt = getattr(torch, dtype)
    rel = 1e-12 if dt == torch.float64 else 1e-4
    linv_rel = (1e-10 if dt == torch.float64 else 5e-2) if ill else rel
    tol = float(torch.finfo(dt).eps)
    make = _ill_conditioned if ill else _spd_batch

    def close(what, got, ref):
        errs = [float((g - r).abs().max()) / float(r.abs().max()) for g, r in zip(got, ref)]
        print(f"{what}: relative error L {errs[0]:.3e} Linv {errs[1]:.3e} d {errs[2]:.3e}")
        for g, e, bar in zip(got, errs, (rel, linv_rel, rel)):
            assert bool(torch.isfinite(g).all())
            assert e <= bar

    A = make(B, nb, nb, dt, cuda)
    before = _n("chol_block")
    got = tchol.chol_block(A, tol)
    torch.cuda.synchronize()
    assert _n("chol_block") == before + 1
    close("chol_block", got, tchol.chol_block_reference(A, tol))
    N = 1024 if nb < 512 else 1536
    A = make(B, N, N, dt, cuda)
    before = _n("chol_fused")
    got = tchol.chol_fused(A, tol, nb)
    torch.cuda.synchronize()
    assert _n("chol_fused") == before + 1
    close(f"chol_fused N={N}", got, tchol.chol_fused_reference(A, tol, nb))


@pytest.mark.parametrize("nb", [100, 128, 256, 512])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chol_block_bit_equal_to_plain_on_card(cuda, dtype, nb):
    """One block's L and raw pivots d are the plain version's bit for bit:
    every element gets its updates in ascending column order, a multiply
    then a subtract, and the pivots come from the same expressions
    (nb = 100 takes the kernel's padded last tile)."""
    dt = getattr(torch, dtype)
    tol = float(torch.finfo(dt).eps)
    for A in (_spd_batch(3, nb, nb + 1, dt, cuda), _ill_conditioned(2, nb, nb, dt, cuda)):
        L, _, d = tchol.chol_block(A, tol)
        torch.cuda.synchronize()
        Lr, _, dr = tchol.chol_block_reference(A, tol)
        assert torch.equal(L, Lr) and torch.equal(d, dr)


def test_chol_kernels_ok_verdict_on_card(cuda):
    """The ok verdict, with an indefinite lane and a tiny-pivot lane, on
    the fused route (N = 300) and, in float64, the blocked route (N = 1024)."""
    for dt in (torch.float64, torch.float32):
        rel = 1e-12 if dt == torch.float64 else 1e-4
        tol = float(torch.finfo(dt).eps)
        for N in (300, 1024):
            A = _spd_batch(3, N, 7, dt, cuda)
            A[1] -= 3 * N * torch.eye(N, dtype=dt, device=cuda)
            A[2] = torch.eye(N, dtype=dt, device=cuda)
            A[2, 7, 7] = tol / 100
            fac = tchol.block_cholesky(A, tol, nb=256)
            torch.cuda.synchronize()
            ref = tchol.block_cholesky_reference(A, tol, nb=256)
            assert fac.ok.tolist() == ref.ok.tolist() == [True, False, False]
            for g, r in ((fac.L, ref.L), (fac.Linv, ref.Linv), (fac.d, ref.d)):
                assert bool(torch.isfinite(g).all())
                assert float((g - r).abs().max()) <= rel * float(r.abs().max())


def test_problem_defaults_to_the_card(cuda):
    from cannoles_tpu_torch import nls_problem

    pb = nls_problem(lambda x: torch.stack([x[0] - 1, x[1]]), np.zeros(2), 2)
    assert pb.x0.device.type == "cuda"
    assert lm_bench_family(torch.float64).x0.device.type == "cuda"
    pb_cpu = nls_problem(lambda x: torch.stack([x[0] - 1, x[1]]), np.zeros(2), 2, device="cpu")
    assert pb_cpu.x0.device.type == "cpu"


def test_chol_kernels_reject_what_they_do_not_take(cuda):
    A = _spd_batch(2, 256, 0, torch.float64, cuda)
    before = (_n("chol_block"), _n("chol_fused"))
    with pytest.raises(TypeError):
        tchol.chol_block(A.half(), 1e-3)
    with pytest.raises(ValueError):
        tchol.chol_block(A[:, :, :128], 1e-12)  # not square
    with pytest.raises(ValueError, match="multiple"):
        tchol.chol_fused(A, 1e-12, 100)
    assert (_n("chol_block"), _n("chol_fused")) == before


def test_chol_solver_on_card_matches_cpu(cuda):
    """A constrained BA scene, LM, condensed, 'chol' through the kernels
    (pallas_chol_min=0) in float64: every counter equal on the card and the
    CPU (plain versions), solutions within 1e-10."""
    out = {}
    for where in (cuda, torch.device("cpu")):
        pb, _ = large_bundle_adjustment(4, 80, dtype=torch.float64, device=where)
        s = CaNNOLeSSolver(pb, method="lm", kkt="condensed", linsolve="chol", pallas_chol_min=0)
        before = _n("chol_fused")
        out[where.type] = s.solve(max_time=600.0)
        assert (_n("chol_fused") > before) == (where.type == "cuda")
    g, c = out["cuda"], out["cpu"]
    assert g.status == c.status == "first_order" and g.iter == c.iter
    assert g.solver_specific == c.solver_specific
    np.testing.assert_allclose(g.solution, c.solution, rtol=0, atol=1e-10)


def test_model_builders_default_to_the_card(cuda):
    from cannoles_tpu_torch import models
    from cannoles_tpu_torch.models.families import curve_fit_family

    built = [models.mgh_problem("meyer"), models.hs_problem("hs79"),
             models.lvcon_problem("lvcon_powell_banded"), models.readme_example(),
             models.constrained(models.mgh01()), curve_fit_family(16)]
    for pb in built:
        assert pb.x0.device.type == "cuda", pb.name
        assert pb.F(pb.x0[None], None if pb.data is None else
                    {k: v[None] for k, v in pb.data.items()}).device.type == "cuda"


def test_battery_uniform_pass_on_card_matches_cpu(cuda):
    """Five problems of the battery (one per family, and brown_badly_scaled
    for its scales) through the runner's uniform pass in float64: status,
    counters and solution on the card equal to the CPU's (1e-10 relative)."""
    from cannoles_tpu_torch.battery import run

    names = {"brown_badly_scaled", "watson_9", "helical_valley+linear", "hs46",
             "lvcon_powell_banded_12"}
    out = {}
    for where in ("cuda", "cpu"):
        out[where], _ = run(names, dtype=torch.float64, device=where, max_time=600.0, rescue=False,
                            log=None)
        assert len(out[where]) == 5
    for g, c in zip(out["cuda"], out["cpu"]):
        assert g["status"] == c["status"] and g["solved_uniform"], (g["name"], g["status"], c["status"])
        assert (g["iter"], g["nfact"], g["nlinsolve"]) == (c["iter"], c["nfact"], c["nlinsolve"]), g["name"]
        xg, xc = np.asarray(g["solution"]), np.asarray(c["solution"])
        assert np.abs(xg - xc).max() <= 1e-10 * max(1.0, np.abs(xc).max()), g["name"]


def test_matfree_engines_default_to_the_card(cuda):
    """MatrixFreeSolver and SchurBASolver follow the problem to the card,
    and the BA bench's device defaults to cuda."""
    from cannoles_tpu_torch import MatrixFreeSolver, SchurBASolver
    from cannoles_tpu_torch.bench_ba_large import parser

    pb, _ = large_bundle_adjustment(3, 12, noise=0.0, seed=0)
    assert pb.x0.device.type == "cuda"
    for s in (MatrixFreeSolver(pb), SchurBASolver(pb, 3, 12)):
        assert s.device.type == "cuda"
        st = s.solve(max_iter=2, atol=0.0, rtol=1e-5)
        assert s.last_state.x.device.type == "cuda" and st.iter >= 1
    assert parser().parse_args([]).device == "cuda"


@pytest.mark.parametrize("engine", ["schur", "matfree"])
def test_matfree_engines_on_card_match_cpu(cuda, engine):
    """The 3×12 scene in float64: the same status and counters on the card
    and on the CPU, solutions within 1e-10.  The generic CG engine stops CG
    at eps^0.45, where its iteration count and the last digits of x follow
    rounding (an H100 read ncg 824 against the CPU's 828): for it ncg
    within 1% and x within 1e-8."""
    from cannoles_tpu_torch import MatrixFreeSolver, SchurBASolver, ba_block_jacobi

    out = {}
    for dev in (cuda, torch.device("cpu")):
        pb, _ = large_bundle_adjustment(3, 12, noise=0.0, seed=0, dtype=torch.float64, device=dev)
        s = (SchurBASolver(pb, 3, 12) if engine == "schur"
             else MatrixFreeSolver(pb, cg_maxiter=300, precond=ba_block_jacobi(3, 12)))
        out[dev.type] = s.solve(max_time=600.0, atol=1e-14, rtol=0.0)
    g, c = out["cuda"], out["cpu"]
    assert (g.status, g.iter) == (c.status, c.iter)
    for k in ("nfact", "nlinsolve", "nbk"):
        assert g.solver_specific[k] == c.solver_specific[k], k
    ncg_g, ncg_c = g.solver_specific["ncg"], c.solver_specific["ncg"]
    if engine == "schur":
        assert ncg_g == ncg_c
        assert np.abs(g.solution - c.solution).max() <= 1e-10
    else:
        assert abs(ncg_g - ncg_c) <= max(2, 0.01 * ncg_c)
        assert np.abs(g.solution - c.solution).max() <= 1e-8


def test_checkpoint_saved_on_card_loads_on_cpu(cuda, tmp_path):
    from cannoles_tpu_torch import SchurBASolver, load_state, save_state

    pb, _ = large_bundle_adjustment(3, 12, noise=0.0, seed=0, dtype=torch.float64)
    s = SchurBASolver(pb, 3, 12)
    s.solve(max_iter=2, atol=1e-14, rtol=0.0)
    save_state(tmp_path / "mf.npz", s.last_state)
    back = load_state(tmp_path / "mf.npz", data_template=pb.data, device="cpu")
    assert back.x.device.type == "cpu" and back.data["obs"].device.type == "cpu"
    for f in back._fields[:-1]:
        assert torch.equal(getattr(back, f), getattr(s.last_state, f).cpu()), f
    pc, _ = large_bundle_adjustment(3, 12, noise=0.0, seed=0, dtype=torch.float64, device="cpu")
    st = SchurBASolver(pc, 3, 12).solve(resume_from=back, atol=1e-14, rtol=0.0)
    assert st.status in ("first_order", "small_residual")


def test_cpp_on_card_tensors_matches_cpu_tensors(cuda):
    """linsolve='cpp' takes CUDA tensors through an explicit host round
    trip: the same x and flags as from CPU tensors, back on the card; a
    dense solve with it on the card equals 'ldlt' on the card."""
    from cannoles_tpu_torch import nls_problem
    from cannoles_tpu_torch.ops.cpp_ldlt import cpp_ldlt_factor_solve

    W, rhs, n1 = quasi_definite(9, 12, seed=4)
    for dt in (torch.float64, torch.float32):
        Wc, rc = torch.as_tensor(W, dtype=dt), torch.as_tensor(rhs, dtype=dt)
        x_cpu, ok_cpu = cpp_ldlt_factor_solve(Wc, rc, n1, 1e-13)
        x_gpu, ok_gpu = cpp_ldlt_factor_solve(Wc.to(cuda), rc.to(cuda), n1, 1e-13)
        assert x_gpu.device.type == ok_gpu.device.type == "cuda" and x_gpu.dtype == dt
        assert torch.equal(x_gpu.cpu(), x_cpu) and torch.equal(ok_gpu.cpu(), ok_cpu)
    pb = nls_problem(lambda x: torch.stack([x[0] - 1, 10 * (x[1] - x[0] ** 2)]), [-1.2, 1.0], 2,
                     lambda x: (x.sum() - 1).reshape(1), [0.0], [0.0])
    a, b = (CaNNOLeSSolver(pb, linsolve=k).solve() for k in ("ldlt", "cpp"))
    assert (a.status, a.iter, a.solver_specific["nfact"]) == (b.status, b.iter, b.solver_specific["nfact"])
    assert np.abs(a.solution - b.solution).max() <= 1e-12


def test_separable_fit_on_card_matches_cpu(cuda):
    """The huge separable fit's model at (16,384, 256) in float64: the same
    status on the card and on the CPU; the same counters, ncg within 30
    and x within 5e-8 (the spread of the JAX package's own solves with the
    products summed in other orders), or, where the iteration counts part,
    the named knife edge of tests/test_torch_separable.py: each run stopped
    after step 1 exactly when its ‖∇L‖ there was at most epstol."""
    from cannoles_tpu_torch import MatrixFreeSolver
    from cannoles_tpu_torch.bench_matfree import separable_fit_problem

    out = {}
    for dev in (cuda, torch.device("cpu")):
        pb, _ = separable_fit_problem(16_384, 256, dtype=torch.float64, device=dev)
        duals = []
        s = MatrixFreeSolver(pb, cg_maxiter=100)
        st = s.solve(max_time=600.0, max_iter=30,
                     callback=lambda p, state, stats: duals.append(float(state.normdual[0])))
        out[dev.type] = (st, duals, float(s.last_state.epstol[0]))
    (g, dg, epstol), (c, dc, _) = out["cuda"], out["cpu"]
    assert g.status == c.status == "first_order"
    if g.iter == c.iter:
        for k in ("nfact", "nlinsolve", "neval_residual"):
            assert g.solver_specific[k] == c.solver_specific[k], k
        assert abs(g.solver_specific["ncg"] - c.solver_specific["ncg"]) <= 30
        assert np.abs(g.solution - c.solution).max() <= 5e-8
    else:
        for st, d in ((g, dg), (c, dc)):
            assert st.iter == (1 if d[1] <= epstol else 2), (st.iter, d[1], epstol)


def test_row_sharded_on_card_matches_unsharded(cuda):
    """``solve_row_sharded`` on 2 gloo ranks sharing the card (the problems
    of ``tests/test_schur.py`` and the BA scene of ``tests/test_families.py``,
    float64) against the one-process solve on the card: status and counters
    equal, x within 1e-8 (the JAX test's bar between its sharded and its
    unsharded solve), every rank the same bits, and m not divisible by the
    ranks refused."""
    import torch_ranks
    from cannoles_tpu_torch.models.families import bundle_adjustment
    from cannoles_tpu_torch.parallel.launch import launch
    from cannoles_tpu_torch.parallel.mesh import make_row_mesh
    from cannoles_tpu_torch.parallel.schur import solve_row_sharded

    got = launch(torch_ranks.schur_cases, 2, None)
    one = make_row_mesh(device=cuda)  # no process group here: one rank, the unsharded solve
    refs = {
        "curvefit": solve_row_sharded(torch_ranks.curvefit_problem(8192, device=cuda), one, method="gauss_newton"),
        "constrained": solve_row_sharded(torch_ranks.constrained_problem(4096, device=cuda), one),
        "ba": solve_row_sharded(bundle_adjustment(n_cams=4, n_pts=16, noise=0.0, device=cuda)[0], one,
                                method="gauss_newton"),
    }
    for case, ref in refs.items():
        want = torch_ranks._stats(ref)
        for r in got:
            assert [r[case][k] for k in ("status", "iter", "nfact", "nlinsolve", "nbk")] == \
                [want[k] for k in ("status", "iter", "nfact", "nlinsolve", "nbk")], case
            assert np.abs(r[case]["x"] - want["x"]).max() <= 1e-8, case
            assert np.array_equal(r[case]["x"], got[0][case]["x"]), case
        assert "should be divisible by 2" in got[0]["uneven"]


def test_launch_backend_on_card(cuda):
    """The launcher's backend rule: one rank per card gives the
    device-typed ``cpu:gloo,cuda:nccl`` group, more ranks than cards plain
    gloo; either reduces a CPU tensor and a CUDA tensor on every rank."""
    import torch_ranks
    from cannoles_tpu_torch.parallel.launch import launch

    cards = torch.cuda.device_count()
    for k, backend in ((cards, "nccl"), (cards + 1, "gloo")):
        for got in launch(torch_ranks.backend_probe, k):
            assert backend in got["backend"], got
            assert got["cpu"] == [float(k)] * 2 and got["card"] == [float(k)] * 2, got


MODES = [None, "highest", "float32", "bfloat16", "tensorfloat32"]


@pytest.mark.parametrize("shape", [(1, 1024, 8192), (256, 66, 96)], ids=["large_rung", "ba_rung"])
def test_bf16_route_matches_plain_on_card(cuda, shape):
    """The condensation's one-pass bf16 product (cuBLAS, float32 result) at
    the two rungs' JᵀJ shapes against ``bf16_pass_reference``: both take
    exact products of the same bf16 operands and sum them in float32, so
    each entry lies within 2·K·u·(|a|·|b|) of the other (K the inner
    dimension, u = 2⁻²⁴); the result is not rounded to bf16."""
    from cannoles_tpu_torch.utils.precision import bf16_pass_reference, critical_matmul, matmul_mode

    rng = np.random.default_rng(sum(shape))
    a = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda)
    b = a.mT
    got = critical_matmul(a, b, "bfloat16")
    ref = bf16_pass_reference(a, b)
    with matmul_mode("highest"):
        bound = 2 * shape[-1] * 2.0**-24 * (a.bfloat16().float().abs() @ b.bfloat16().float().abs())
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert bool(((got - ref).abs() <= bound).all())
    assert not torch.equal(got, got.bfloat16().float())


def test_pinned_sites_bit_equal_under_tf32(cuda):
    """The sites the JAX package pins to 'highest' give the same bits
    inside a TF32 scope and an IEEE one: the gate residual, a ``chol``
    attempt at each seam (S = δI + ZᵀZ, triangular and Cholesky solves) and
    an ``ldlt`` attempt; an unpinned product of the same operands does not."""
    from cannoles_tpu_torch import nls_problem
    from cannoles_tpu_torch.utils.precision import matmul_mode

    f32 = dict(dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(20)
    n, p = 512, 6
    G = rng.normal(size=(n, n)) / np.sqrt(n)
    Jc = rng.normal(size=(p, n))
    K = torch.as_tensor(np.block([[G @ G.T + np.eye(n), Jc.T], [Jc, -1e-2 * np.eye(p)]])[None], **f32)
    rhs, sol = (torch.as_tensor(rng.normal(size=(1, n + p)), **f32) for _ in range(2))
    pb = nls_problem(lambda x: x, torch.zeros(n, **f32), n, lambda x: x[:p], np.zeros(p), np.zeros(p))
    chol = [CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="chol",
                           matmul_precision="tensorfloat32", pallas_chol_min=pcm) for pcm in (None, 0)]
    W2, r2, n1 = quasi_definite(1, 120, seed=21, skip=False)
    pb2 = nls_problem(lambda x: x, torch.zeros(n1, **f32), 120 - n1)
    ldlt = CaNNOLeSSolver(pb2, method="gauss_newton", linsolve="ldlt", matmul_precision="tensorfloat32")
    W2, r2 = torch.as_tensor(W2, **f32), torch.as_tensor(r2, **f32)
    sites = [lambda: (chol[0]._gate_residual(K, sol, rhs),), lambda: chol[0]._attempt_raw(K, rhs),
             lambda: chol[1]._attempt_raw(K, rhs), lambda: ldlt._attempt_raw(W2, r2)]

    def both(fn):
        with matmul_mode("tensorfloat32"):
            a = fn()
        with matmul_mode("highest"):
            b = fn()
        return all(torch.equal(x, y) for x, y in zip(a, b))

    assert [both(fn) for fn in sites] == [True] * len(sites)
    assert not both(lambda: (K @ K,))


@pytest.mark.parametrize("mode", MODES)
def test_vsolve_f64_on_card_matches_cpu_under_each_mode(cuda, mode):
    """float64 is IEEE float64 under every mode: the bench family through
    vsolve on the card and the CPU, per-lane status and counters equal,
    solutions within 1e-10."""
    x0, d = lm_bench_batch(32, seed=5)
    out = {}
    for where in (cuda, torch.device("cpu")):
        pb = lm_bench_family(torch.float64, where)
        s = CaNNOLeSSolver(pb, method="lm", linsolve="pallas", kkt="full", matmul_precision=mode)
        out[where.type] = vsolve(pb, x0, data_batch=d, solver=s, max_iter=50, rescue=True)
    g, c = out["cuda"], out["cpu"]
    for f in ("status", "iter", "nfact", "nbk", "nlinsolve", "msg"):
        assert torch.equal(getattr(g.states, f).cpu(), getattr(c.states, f)), f
    np.testing.assert_allclose(g.solution, c.solution, rtol=0, atol=1e-10)


def _bits_equal(a, b):
    """Two states (or batches of them) equal bit for bit, field by field."""
    for f in a._fields[:-1]:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype.is_floating_point:
            it = {4: torch.int32, 8: torch.int64}[x.element_size()]
            x, y = x.contiguous().view(it), y.contiguous().view(it)
        assert torch.equal(x, y), f


def _eager(solver):
    solver.route, solver.route_reason = "eager", "test"
    return solver


def test_graph_route_equals_eager_route_at_b1_on_card(cuda):
    """B = 1 (a battery solve, ``biggs_exp6_24`` f64, capped at 60 outer
    iterations, and example 01's constrained problem with the eigh fallback
    ladder, whose attempts run eagerly on the graph route): the graph
    route's states, counters and host checks equal the eager route's bit
    for bit."""
    from cannoles_tpu_torch import battery, nls_problem

    make = next(it[2] for it in battery.collect() if it[1] == "biggs_exp6_24")

    def ex01():
        return nls_problem(lambda x: torch.stack([x[0] - 1, 10 * (x[1] - x[0] ** 2)]), [-1.2, 1.0], 2,
                           cons=lambda x: (x[0] + x[1]).reshape(1), lcon=[1.0], ucon=[1.0], device=cuda)

    cases = [(lambda: make(dtype=torch.float64, device=cuda), dict(linsolve="ldlt"),
              dict(atol=0.0, rtol=1e-5, max_iter=60)),
             (ex01, dict(robust_fallback=True), dict())]
    for build, kw, solve_kw in cases:
        runs = []
        for route in ("graph", "eager"):
            s = CaNNOLeSSolver(build(), **kw)
            assert s.route == "graph" and s.route_reason == "cuda"
            if route == "eager":
                _eager(s)
            st = s.solve(max_time=600.0, **solve_kw)
            runs.append((s, st))
        (g, a), (e, b) = runs
        assert sum(g.graph_replays().values()) > 0 and e.graph_replays() == {}
        assert (a.status, a.iter, a.solver_specific) == (b.status, b.iter, b.solver_specific)
        assert g.host_syncs == e.host_syncs
        _bits_equal(g.last_state, e.last_state)


def test_graph_route_equals_eager_route_at_b48_on_card(cuda):
    """B = 48 (the headline family's rescue size, float32, LM, full KKT,
    the fused LDLᵀ kernel, with the rescue): every lane bit-equal between
    the routes, and the kernel's launches counted alike (a replay adds what
    its capture launched)."""
    x0, d = lm_bench_batch(48, seed=0)
    runs = []
    for route in ("graph", "eager"):
        pb = lm_bench_family(torch.float32, cuda)
        s = CaNNOLeSSolver(pb, method="lm", linsolve="pallas", kkt="full", dtype=torch.float32, device=cuda)
        if route == "eager":
            _eager(s)
        l0, by0 = _n("fused_ldlt"), _by_shape()
        res = vsolve(pb, torch.as_tensor(x0, dtype=torch.float32, device=cuda),
                     data_batch=torch.as_tensor(d, dtype=torch.float32, device=cuda), solver=s,
                     max_iter=50, max_eval=48, rescue=True)
        torch.cuda.synchronize()
        by = {k: n - by0.get(k, 0) for k, n in _by_shape().items() if n != by0.get(k, 0)}
        runs.append((res.states, _n("fused_ldlt") - l0, by))
    (a, la, ba), (b, lb, bb) = runs
    _bits_equal(a, b)
    assert la == lb > 0 and ba == bb and sum(ba.values()) == la


@pytest.mark.parametrize("seed,n,max_numel", [(0, 20, 8), (1, 60, 40), (2, 150, 30), (3, 40, 3000),
                                              (4, 100, 40_000), (5, 300, 4_000)],
                         ids=["tiny", "one_block", "above_cap", "staged", "grid", "grid_above_cap"])
def test_bank_copy_kernel_bit_equal_to_plain_on_card(cuda, seed, n, max_numel):
    """``ops/bank_copy.py``'s kernel on random stores (``copy_layout``: six
    dtypes, offsets off 16-byte alignment, sources sharing memory with
    destinations, strided sources left to ``copy_``): the card's pools after
    the store equal the plain version's on the CPU and the expected bytes,
    on the one-block path, above the cap, staged and on the grid path; one
    launch counted per launch of the plan on the card, none for the plain
    version."""
    from cannoles_tpu_torch.ops import bank_copy
    from cannoles_tpu_torch.utils.testing import copy_expected, copy_layout, copy_pairs

    pool, other, entries = copy_layout(seed, n, max_numel)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        tp, to = torch.as_tensor(pool, device=dev).clone(), torch.as_tensor(other, device=dev).clone()
        pairs = copy_pairs(entries, tp, to)
        plan, _ = bank_copy.plan(pairs, {bank_copy._storage(d) for d, _ in pairs})
        l0 = _n("bank_copy")
        bank_copy.store(pairs)
        assert _n("bank_copy") - l0 == (len(plan) if dev.type == "cuda" else 0) and plan
        out[dev.type] = (tp.cpu().numpy(), to.cpu().numpy())
    assert np.array_equal(out["cuda"][0], out["cpu"][0]) and np.array_equal(out["cuda"][1], other)
    assert np.array_equal(out["cuda"][0], copy_expected(entries, pool, other))


def _copy_counts():
    c = segments.counters()
    return np.array([c["bank_copy"], c[("bank_copy", "entries")], c[("bank_copy", "left")]])


@pytest.mark.parametrize("B", [1, 72, 16384])
def test_graph_route_equals_eager_route_with_the_batched_copy_on_card(cuda, B):
    """The headline family (float32, LM, full KKT, the fused LDLᵀ kernel,
    the rescue) at B = 1, the rescue's size and a chunk's: every lane
    bit-equal between the routes while the graph route's stores go through
    the batched copy (entries folded, launches counted per replay), and the
    eager route copies nothing."""
    x0, d = lm_bench_batch(B, seed=B)
    runs = []
    for route in ("graph", "eager"):
        pb = lm_bench_family(torch.float32, cuda)
        s = CaNNOLeSSolver(pb, method="lm", linsolve="pallas", kkt="full", dtype=torch.float32, device=cuda)
        if route == "eager":
            _eager(s)
        c0 = _copy_counts()
        res = vsolve(pb, torch.as_tensor(x0, dtype=torch.float32, device=cuda),
                     data_batch=torch.as_tensor(d, dtype=torch.float32, device=cuda), solver=s,
                     max_iter=50, max_eval=48, rescue=True)
        torch.cuda.synchronize()
        runs.append((res.states, _copy_counts() - c0))
    (a, ca), (b, cb) = runs
    _bits_equal(a, b)
    assert ca[0] > 0 and ca[1] > 0 and ca[1] >= 0.95 * (ca[1] + ca[2]), ca
    assert not cb.any(), cb


def test_graph_route_equals_eager_route_condensed_chol_with_the_batched_copy_on_card(cuda):
    """The large rung (8,192 x 1,024 float32, Gauss–Newton, condensed,
    ``chol``) solved on both routes: bit-equal states and statistics; its
    J-sized copies, above ``CUT_BYTES``, stay on ``copy_``, the rest fold."""
    from cannoles_tpu_torch.models.families import large_rung_problem
    from cannoles_tpu_torch.ops import bank_copy

    pb = large_rung_problem(dtype=torch.float32, device=cuda)[0]
    runs = []
    for route in ("graph", "eager"):
        s = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="chol", dtype=torch.float32)
        if route == "eager":
            _eager(s)
        c0 = _copy_counts()
        st = s.solve(max_iter=30, max_time=600.0)
        torch.cuda.synchronize()
        runs.append((s, st, _copy_counts() - c0))
    (g, a, ca), (e, b, cb) = runs
    assert a.status == "first_order" and (a.status, a.iter, a.solver_specific) == (b.status, b.iter, b.solver_specific)
    _bits_equal(g.last_state, e.last_state)
    assert ca[1] > 0 and ca[2] > 0 and not cb.any(), ca
    assert 8192 * 1024 * 4 > bank_copy.CUT_BYTES


def test_spans_on_the_graph_route_on_card(cuda):
    """The spans of ``utils/spans.py`` on the graph route: a sweep of the
    headline family with its cap and rescue, warm, then in a profiler
    session.  The session holds ``cannoles.replay`` and the rescue's spans,
    no device-side ``cannoles.`` annotation (the spans are function events,
    so the card's operations are its own), and the same bits as the call
    before it; the process's host syncs are every solver's checks plus the
    rescue's status reads."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x0, d = lm_bench_batch(256, seed=0)
    pb = lm_bench_family(torch.float32, cuda)
    s = CaNNOLeSSolver(pb, method="lm", linsolve="pallas", kkt="full", dtype=torch.float32, device=cuda)

    def call():
        out = vsolve(pb, torch.as_tensor(x0, dtype=torch.float32, device=cuda),
                     data_batch=torch.as_tensor(d, dtype=torch.float32, device=cuda), solver=s,
                     max_iter=50, max_eval=12, chunk_size=64, rescue=True)
        torch.cuda.synchronize()
        return out.states

    call()
    sibs = s.__dict__.get("_rescue_siblings", {})
    syncs0 = s.host_syncs + sum(x.host_syncs for x in sibs.values())
    c0 = segments.counters()
    a = call()
    c1 = segments.counters()
    syncs = s.host_syncs + sum(x.host_syncs for x in sibs.values()) - syncs0
    reads = c1[("host_syncs", "rescue.status")] - c0[("host_syncs", "rescue.status")]
    assert reads >= 2 and c1["host_syncs"] - c0["host_syncs"] == syncs + reads
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        b = call()
    _bits_equal(a, b)
    events = prof.profiler.kineto_results.events()
    host = {e.name() for e in events if e.device_type() != DeviceType.CUDA and e.name().startswith("cannoles.")}
    assert {"cannoles.vsolve", "cannoles.chunk", "cannoles.run", "cannoles.replay", "cannoles.check",
            "cannoles.rescue", "cannoles.rescue.stage0", "cannoles.host_read"} <= host
    assert not [e.name() for e in events if e.device_type() == DeviceType.CUDA and e.name().startswith("cannoles.")]


def test_graph_route_raises_on_a_residual_with_host_data(cuda):
    """A residual that builds a tensor from host data at every call cannot
    be captured: the graph route raises ``GraphCaptureError`` naming the
    problem and the segment, and never falls back to the eager route."""
    from cannoles_tpu_torch import nls_problem
    from cannoles_tpu_torch.core.segments import GraphCaptureError

    def residual(x):
        return x - torch.tensor([1.0, 2.0], dtype=x.dtype, device=x.device)

    pb = nls_problem(residual, [0.0, 0.0], 2, device=cuda, name="host_data")
    with pytest.raises(GraphCaptureError, match=r"host_data.*segment"):
        CaNNOLeSSolver(pb).solve(max_time=60.0)
    torch.cuda.synchronize()
    s = _eager(CaNNOLeSSolver(pb))
    assert s.solve(max_time=60.0).status == "first_order"


def test_mesh_and_cpp_take_the_eager_route_on_card(cuda):
    """The route rule: a row mesh (its all-reduces go through the host) and
    ``linsolve='cpp'`` (a host round trip per attempt) take the eager route,
    recorded on the solver; a plain solver on the card takes the graph
    route."""
    from cannoles_tpu_torch.models.families import bundle_adjustment
    from cannoles_tpu_torch.parallel.mesh import make_row_mesh

    pb = bundle_adjustment(n_cams=3, n_pts=16, noise=0.0, device=cuda)[0]
    s = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", mesh=make_row_mesh(device=cuda))
    assert (s.route, s.route_reason) == ("eager", "mesh")
    c = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="cpp")
    assert (c.route, c.route_reason) == ("eager", "cpp")
    assert c.solve(max_time=600.0, max_iter=3).iter >= 1 and c.graph_replays() == {}
    g = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed")
    assert (g.route, g.route_reason) == ("graph", "cuda")


@pytest.mark.parametrize("N", [256, 2048])
def test_bench_chol_rows_on_card(cuda, N):
    """``bench_chol``'s rows at N = 256 (the fused kernel) and 2,048 (the
    blocked route, the block kernel once per diagonal block): the factor
    against the plain version (phase 7's 1e-4 for float32), the solve
    against ``torch.cholesky_solve`` (``rel_err`` ≤ 1e-4), the kernels'
    counters and CUDA-event times beside ``torch.linalg.cholesky``'s."""
    from cannoles_tpu_torch import bench_chol

    row = bench_chol.row(N, cuda, plain=False)
    fused = N * N * 4 <= 1280 * 1280 * 4
    assert row["ok"] and row["rel_err"] <= 1e-4
    assert (row["launches_fused"], row["launches_block"]) == ((1, 0) if fused else (0, N // bench_chol.NB))
    assert row["kernel_ms"] > 0 and row["cholesky_ms"] > 0 and 0 < row["share_of_bound"] <= 1
    A, _ = bench_chol._inputs(N, cuda)
    fac = tchol.block_cholesky(A[None], bench_chol.TOL, bench_chol.NB)
    ref = tchol.block_cholesky_reference(A[None], bench_chol.TOL, bench_chol.NB)
    assert float((fac.L - ref.L).abs().max()) <= 1e-4 * float(ref.L.abs().max())
    assert float((fac.L - torch.linalg.cholesky(A)[None]).abs().max()) <= 1e-4 * float(ref.L.abs().max())


def test_mesh2d_on_card_matches_one_process(cuda):
    """The 2-D mesh at 2 × 2 gloo ranks sharing the card (float64): each
    case of ``torch_ranks.MESH2D_CASES`` against the one-process solve on
    the card, status and counters equal, x within 1e-10, every rank the
    same bits, uneven B and m refused."""
    import torch_ranks
    from cannoles_tpu_torch.parallel.launch import launch

    got = launch(torch_ranks.mesh2d_cases, 4, 2, 2, None)
    for case in torch_ranks.MESH2D_CASES:
        one = torch_ranks.mesh2d_solve(None, case, device=cuda)
        for r in got:
            for k in ("status", "iter", "nfact", "nlinsolve"):
                assert np.array_equal(r[case][k], one[k]), (case, k)
            assert np.abs(r[case]["x"] - one["x"]).max() <= 1e-10, case
            assert np.array_equal(r[case]["x"], got[0][case]["x"]), case
    assert all("should be divisible by 2" in r["uneven_B"] and "should be divisible by 2" in r["uneven_m"]
               for r in got)


def _exp_fit_on(dev, dtype, B, route, pallas_chol_min=None):
    """The 2-D mesh's exp-fit batch (``torch_ranks.exp_fit_batch``, m = 32)
    in ``dtype`` through ``vsolve`` (Gauss–Newton, condensed,
    ``linsolve="chol"``) on ``route``: the solver and the states."""
    import torch_ranks
    from cannoles_tpu_torch import nls_problem

    t, y = torch_ranks.exp_fit_batch(B)
    own = {"t": torch.as_tensor(t[0], dtype=dtype, device=dev), "y": torch.as_tensor(y[0], dtype=dtype, device=dev)}
    pb = nls_problem(lambda x, d: x[0] * torch.exp(-x[1] * d["t"]) - d["y"], [1.0, 0.0], 32, data=own,
                     name="exp_fit", dtype=dtype, device=dev)
    s = CaNNOLeSSolver(pb, method="gauss_newton", linsolve="chol", kkt="condensed", pallas_chol_min=pallas_chol_min)
    if route == "eager":
        _eager(s)
    x0 = np.tile(pb.x0.cpu().numpy(), (B, 1))
    return s, vsolve(pb, x0, data_batch={"t": t, "y": y}, solver=s, max_iter=20).states


@pytest.mark.parametrize("pallas_chol_min", [None, 0], ids=["cholesky", "kernels"])
@pytest.mark.parametrize("B", [4, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_chol_batch_on_graph_route_on_card(cuda, dtype, B, pallas_chol_min):
    """``linsolve="chol"`` at B > 1 on the graph route (ROADMAP queue 3 C4:
    a batched ``torch.cholesky_solve`` went to MAGMA, which allocates inside
    the capture): the exp-fit batch captures and replays, its states equal
    the eager route's bit for bit and its statuses the CPU run's (every lane
    ``first_order``); with ``pallas_chol_min=0`` the n = 2 block, padded to
    128, goes through the Cholesky kernel inside the captured segments,
    counted alike on both routes."""
    runs = {}
    for route in ("graph", "eager"):
        f0 = _n("chol_fused")
        s, st = _exp_fit_on(cuda, dtype, B, route, pallas_chol_min)
        torch.cuda.synchronize()
        runs[route] = (s, st, _n("chol_fused") - f0)
    (g, a, la), (_, b, lb) = runs["graph"], runs["eager"]
    assert (g.route, g.route_reason) == ("graph", "cuda") and g.graph_replays().get("solve0", 0) > 0
    _bits_equal(a, b)
    _, c = _exp_fit_on(torch.device("cpu"), dtype, B, "eager", pallas_chol_min)
    assert torch.equal(a.status.cpu(), c.status) and set(c.status.tolist()) == {1}
    assert la == lb and (la > 0) == (pallas_chol_min == 0)


@pytest.mark.parametrize("B,N", [(4, 2), (64, 2), (8, 300), (64, 300), (16, 600), (64, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_chol_steps_capture_at_b_above_1_on_card(cuda, dtype, B, N):
    """The solver's batched Cholesky steps (``_cholesky_nan``, then
    ``_cho_solve``'s two triangular solves) captured as one CUDA graph:
    the replay equals the eager call bit for bit, from the exp-fit batch's
    N = 2 up to B = 64, N = 1,024 (PyTorch picks cuBLAS or MAGMA for a
    triangular solve by B and N; a batched ``torch.cholesky_solve`` went to
    MAGMA's ``potrs_batched``, which allocates inside a capture)."""
    from cannoles_tpu_torch.core.solver import _cho_solve, _cholesky_nan

    g = torch.Generator().manual_seed(N)
    A = torch.randn(B, N, N, dtype=dtype, generator=g) / N ** 0.5
    A = (A @ A.mT + torch.eye(N, dtype=dtype)).to(cuda)
    b = torch.randn(B, N, dtype=dtype, generator=g).to(cuda)
    ref = _cho_solve(_cholesky_nan(A), b)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _cho_solve(_cholesky_nan(A), b)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_vsolve_auto_takes_chol_on_the_graph_route_on_card(cuda):
    """``vsolve(linsolve="auto")`` on a condensed Gauss–Newton family with
    n + p = 256 > 240, the fused kernel's float32 cap (the large rung's
    problem at m = 512, n = 256, eight data draws, B = 8): it picks
    ``chol``, takes the graph route and solves every lane."""
    from cannoles_tpu_torch.models.families import large_rung_problem

    m, n, B = 512, 256, 8
    pb = large_rung_problem(m, n, seed=0, device=cuda)[0]
    draws = [large_rung_problem(m, n, seed=k, device=cuda)[0].data for k in range(B)]
    data = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
    res = vsolve(pb, torch.zeros(B, n, device=cuda), data_batch=data, method="gauss_newton", kkt="condensed",
                 linsolve="auto", max_iter=30)
    s = res.solver
    assert s.linsolve == "chol" and (s.route, s.route_reason) == ("graph", "cuda")
    assert s.graph_replays().get("solve0", 0) > 0
    assert res.states.status.tolist() == [1] * B


def test_graph_route_peak_memory_at_the_large_rung_on_card(cuda):
    """ROADMAP queue 3 C1: three solves of the large rung (8192 x 1024 f32,
    ``chol``) on one solver; the graph route's peak allocated memory is at
    most 1.25 times the eager route's (0.723 against 0.392 GB on an H100
    80GB HBM3 at 700 W while the bank copied the data into each state it
    kept)."""
    import gc

    from cannoles_tpu_torch.models.families import large_rung_problem

    pb = large_rung_problem(dtype=torch.float32, device=cuda)[0]
    peak = {}
    for route in ("eager", "graph"):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(cuda)
        s = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="chol", block_size=256,
                           dtype=torch.float32)
        if route == "eager":
            _eager(s)
        assert [s.solve(max_iter=30, max_time=600.0).status for _ in range(3)] == ["first_order"] * 3
        torch.cuda.synchronize()
        peak[route] = torch.cuda.max_memory_allocated(cuda)
        del s
    assert peak["graph"] <= 1.25 * peak["eager"], peak


def test_debug_print_rows_equal_on_both_routes_on_card(cuda):
    """``debug_print=True`` at B = 48 (the headline family, float32, the
    fused kernel): the graph route prints the eager route's rows, one per
    lane that took the outer iteration."""
    import contextlib
    import io

    x0, d = lm_bench_batch(48, seed=0)
    rows = {}
    for route in ("graph", "eager"):
        pb = lm_bench_family(torch.float32, cuda)
        s = CaNNOLeSSolver(pb, method="lm", linsolve="pallas", kkt="full", dtype=torch.float32, debug_print=True)
        if route == "eager":
            _eager(s)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = vsolve(pb, torch.as_tensor(x0, dtype=torch.float32, device=cuda),
                         data_batch=torch.as_tensor(d, dtype=torch.float32, device=cuda), solver=s, max_iter=50)
        rows[route] = buf.getvalue().splitlines()
        assert len(rows[route]) == int(res.states.iter.sum())
    assert rows["graph"] == rows["eager"]


def test_bench_rungs_on_card(cuda):
    """``cannoles_tpu_torch.bench`` at small shapes on the card: a ladder
    rung of 256 lanes, the BA rung at 16 scenes and the large rung at
    1024 x 128, with the device's busy time measured (or None where the
    profiler does not record the card) and every solve solved."""
    from cannoles_tpu_torch import bench

    value, summ, dt = bench.run_config(lm_bench_family(torch.float32, cuda), "pallas", 256, None, torch.float32, reps=1)
    assert summ["solved"] >= 0.99 * 256 and value == pytest.approx(256 / dt)
    sps, sps_dev, solved, mfu, dt = bench.run_ba_rung(reps=1, device=cuda, scenes=16)
    assert solved == "16/16" and (sps_dev is None) == (mfu is None)
    ms, ms_dev, ms_bf16, mfu, status, err = bench.run_large_rung(cuda, 1024, 128, reps=1)
    assert status == 1 and err <= 1e-3 and ms > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_schur_pairs_kernel_matches_plain_at_dubrovnik_size_on_card(cuda, dtype):
    """The pair kernel at BAL Dubrovnik-356's pairs (5.94M, 356 cameras of 9
    parameters): against its plain version (float64 to 1e-12, float32 to
    1e-5 of each block's scale: the two sum in other orders), bit-equal to
    itself across two launches, one launch counted."""
    from cannoles_tpu_torch.models.bal import draw_scene
    from cannoles_tpu_torch.ops import schur_pairs

    dt = getattr(torch, dtype)
    sc = draw_scene(356, 226_730, 1_255_268, seed=0)
    pp = schur_pairs.plan(sc["cam_idx"].to(cuda), sc["pt_idx"].to(cuda), 356)
    assert pp.n_pairs > 5_900_000 and pp.n_blocks <= 356 * 357 // 2
    g = torch.Generator(device=cuda).manual_seed(11)
    X = torch.randn((1_255_268, 9, 3), generator=g, dtype=dt, device=cuda)
    W = torch.randn((1_255_268, 9, 3), generator=g, dtype=dt, device=cuda)
    before = _n("schur_pairs")
    T1 = schur_pairs.accumulate(X, W, pp)
    T2 = schur_pairs.accumulate(X, W, pp)
    torch.cuda.synchronize()
    assert _n("schur_pairs") == before + 2
    assert torch.equal(T1, T2)
    ref = schur_pairs.plain(X, W, pp)
    scale = ref.abs().flatten(1).amax(1).clamp_min(1.0)[:, None, None]
    assert float(((T1 - ref).abs() / scale).max()) <= (1e-12 if dt == torch.float64 else 1e-5)
    T6 = schur_pairs.accumulate(X[:, :6].contiguous(), W[:, :6].contiguous(), pp)
    ref6 = schur_pairs.plain(X[:, :6].contiguous(), W[:, :6].contiguous(), pp)
    assert float((T6 - ref6).abs().max()) <= (1e-12 if dt == torch.float64 else 1e-5) * float(ref6.abs().max())
    with pytest.raises(ValueError, match="6 or 9"):
        schur_pairs.accumulate(X[:, :4].contiguous(), W[:, :4].contiguous(), pp)


def test_bal_solve_on_card_against_the_float64_reference(cuda):
    """One LM solve of a tenth of Dubrovnik-356 (36 cameras, 22,673 points,
    125,527 observations) in float32 on the card: first_order, one pair
    launch a camera system, bit-equal across two solves, and the cost within
    1e-3 of the float64 reference's optimum (``tests/bal_plain.py`` on the
    card) with the first-order measure under twice the stated tolerance."""
    import bal_plain as bp

    from cannoles_tpu_torch.core.ba import SchurBASolver
    from cannoles_tpu_torch.models.bal import bal_scene

    C, P = 36, 22_673
    pb, _ = bal_scene(C, P, 125_527, seed=0, dtype=torch.float32, device=cuda)
    runs = []
    for _ in range(2):
        s = SchurBASolver(pb, C, P, method="lm", use_initial_multiplier=True)
        c0 = segments.counters()
        st = s.solve(max_iter=50)
        c1 = segments.counters()
        runs.append((st, s.last_state))
        assert st.status == "first_order", st.status
        assert c1["schur_pairs"] - c0["schur_pairs"] == c1[("schur", "assemble")] - c0.get(("schur", "assemble"), 0)
        assert c1["schur_pairs"] - c0["schur_pairs"] == st.solver_specific["nfact"]
    (a, sa), (b, sb) = runs
    assert (a.iter, a.solver_specific["nfact"]) == (b.iter, b.solver_specific["nfact"])
    assert torch.equal(sa.x, sb.x) and torch.equal(sa.lam, sb.lam)
    sc = bp.scene(pb, C, P)
    x0 = pb.x0.to(torch.float64)
    _, f_ref = bp.solve(x0, sc)
    x = sa.x[0].to(torch.float64)
    assert (bp.cost(x, sc) - f_ref) / f_ref <= 1e-3
    tol = bp.tolerance(x0, sc, float(torch.finfo(torch.float32).eps))
    assert bp.measure(x, sa.r[0].to(torch.float64), sa.lam[0].to(torch.float64), sc) <= 2 * tol


# every entry of the kernel within this share of the sum of its terms'
# magnitudes from the plain version: the two sum in other orders (the plain
# version after cuBLAS's contracted products, the kernel by a fixed tree
# with each product rounded), and either order's rounding is a few units of
# the last place of that sum, times at most the segment's length under a
# random walk, far below the bar at 3,500 terms a camera
_OBS_BAR = {torch.float32: 1e-5, torch.float64: 1e-12}


def _obs_inputs(sl, n_obs, cd, dt, dev, lanes, seed, layout):
    """Random blocks and vectors of every kind: A and Bm as the forward-mode
    Jacobian leaves them (views of one (n_obs, cd + 3, 2) record an
    observation) or contiguous; X and W contiguous."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=dt, device=dev)

    J = rnd(lanes, n_obs, cd + 3, 2).transpose(-1, -2)
    A, Bm = J[..., :cd], J[..., cd:]
    if layout == "contiguous":
        A, Bm = A.contiguous(), Bm.contiguous()
    n = cd * sl.n_cams + 3 * sl.n_pts
    X, W = rnd(lanes, n_obs, cd, 3), rnd(lanes, n_obs, cd, 3)
    return {
        "jv": (A, Bm, rnd(lanes, n)),
        "jtw": (A, Bm, rnd(lanes, 2 * n_obs)),
        "reduce": (X, rnd(lanes, sl.n_pts, 3)),
        "lift": (W, rnd(lanes, sl.n_cams, cd)),
        "uv": (A, Bm),
    }


def _obs_check(kind, args, sl, dt):
    """(largest |kernel - plain| over the terms' magnitudes, bit-equal
    across two launches) of one kind."""
    from cannoles_tpu_torch.ops import obs_products

    k1 = getattr(obs_products, kind)(*args, sl)
    k2 = getattr(obs_products, kind)(*args, sl)
    ref = getattr(obs_products, f"plain_{kind}")(*args, sl)
    mag = getattr(obs_products, f"plain_{kind}")(*(a.abs() for a in args), sl)
    torch.cuda.synchronize()
    tup = (lambda t: t if isinstance(t, tuple) else (t,))
    worst = max(float(((a - r).abs() / m.clamp_min(torch.finfo(dt).tiny)).max())
                for a, r, m in zip(tup(k1), tup(ref), tup(mag)))
    return worst, all(torch.equal(a, b) for a, b in zip(tup(k1), tup(k2)))


@pytest.mark.parametrize("cd", [9, 6])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_obs_products_kernel_matches_plain_at_dubrovnik_size_on_card(cuda, dtype, cd):
    """The products kernel at BAL Dubrovnik-356's lists (356 cameras,
    226,730 points, 1,255,268 observations), each of its five kinds on both
    block layouts: against the plain version within ``_OBS_BAR`` of the
    terms' magnitudes, bit-equal across two launches, each launch counted."""
    from cannoles_tpu_torch.models.bal import draw_scene
    from cannoles_tpu_torch.ops import obs_products

    dt = getattr(torch, dtype)
    C, P, n_obs = 356, 226_730, 1_255_268
    sc = draw_scene(C, P, n_obs, seed=0)
    sl = obs_products.lists(sc["cam_idx"].to(cuda), sc["pt_idx"].to(cuda), C, P)
    before, made = _n("obs_products"), 0
    for layout in ("forward", "contiguous"):
        for kind, args in _obs_inputs(sl, n_obs, cd, dt, cuda, 1, 27, layout).items():
            if layout == "contiguous" and kind in ("reduce", "lift"):
                continue
            worst, equal = _obs_check(kind, args, sl, dt)
            made += 2
            assert equal, (kind, layout)
            assert worst <= _OBS_BAR[dt], (kind, layout, worst)
    assert _n("obs_products") == before + made
    with pytest.raises(ValueError, match="6 or 9"):
        A = torch.zeros((1, n_obs, 2, 4), dtype=dt, device=cuda)
        obs_products.uv(A, A[..., :3], sl)


def test_obs_products_kernel_takes_lanes_on_card(cuda):
    """Three lanes of one observation list (a tenth of Dubrovnik-356, the
    list shuffled, so that camera segments are scattered too), vectors that
    are strided views: each kind against its plain version."""
    from cannoles_tpu_torch.models.bal import draw_scene
    from cannoles_tpu_torch.ops import obs_products

    C, P, n_obs = 36, 22_673, 125_527
    sc = draw_scene(C, P, n_obs, seed=1)
    perm = torch.randperm(n_obs, generator=torch.Generator().manual_seed(3))
    sl = obs_products.lists(sc["cam_idx"][perm].to(cuda), sc["pt_idx"][perm].to(cuda), C, P)
    for dt in (torch.float32, torch.float64):
        args = _obs_inputs(sl, n_obs, 9, dt, cuda, 3, 5, "forward")
        wide = torch.randn((3, P, 5), dtype=dt, device=cuda)
        args["reduce"] = (args["reduce"][0], wide[..., 1:4])
        for kind, a in args.items():
            worst, equal = _obs_check(kind, a, sl, dt)
            assert equal and worst <= _OBS_BAR[dt], (kind, dt, worst)


def test_list_route_solve_on_card_takes_the_obs_products_kernel(cuda, monkeypatch):
    """One LM solve of a tenth of Dubrovnik-356 (36 cameras, 22,673 points,
    125,527 observations, float32) on the card through the kernel: the
    status of the same solve with the plain versions on the card, the cost
    within 1e-3 of it (the cell's cost_gap limit: both stop at the stated
    √eps-relative first-order test, in other roundings), every product of
    the solve a launch ("obs_products" against the calls of every kind,
    ("obs_products", kind): 100%)."""
    from cannoles_tpu_torch.core.ba import SchurBASolver
    from cannoles_tpu_torch.core.solver import _add_batch_axis
    from cannoles_tpu_torch.models.bal import bal_scene
    from cannoles_tpu_torch.ops import obs_products

    C, P = 36, 22_673
    pb, _ = bal_scene(C, P, 125_527, seed=0, dtype=torch.float32, device=cuda)
    data = _add_batch_axis(pb.data, cuda)

    def solve():
        s = SchurBASolver(pb, C, P, method="lm", use_initial_multiplier=True)
        st = s.solve(max_iter=50)
        return st, 0.5 * float((pb.F(s.last_state.x, data).double() ** 2).sum())

    c0 = segments.counters()
    st, f = solve()
    c1 = segments.counters()
    calls = {k: c1[("obs_products", k)] - c0[("obs_products", k)] for k in obs_products.KINDS}
    assert all(n > 0 for n in calls.values()), calls
    assert c1["obs_products"] - c0["obs_products"] == sum(calls.values())
    for kind in obs_products.KINDS:
        monkeypatch.setattr(obs_products, kind, getattr(obs_products, f"plain_{kind}"))
    st_plain, f_plain = solve()
    assert segments.counters()["obs_products"] == c1["obs_products"]
    assert st.status == st_plain.status == "first_order"
    assert abs(f - f_plain) <= 1e-3 * f_plain


# A, Bm and W from the blocks kernel within this share of each
# observation's block magnitude (the largest |entry| of its A, Bm or W)
# from the plain version: both form the same derivatives and round them in
# other orders (jacfwd tangent by tangent and W by cuBLAS, the kernel in
# closed form with each product rounded), a few units of the last place
# of the block's largest terms; float32 takes ``_OBS_BAR``'s bar
_BLOCKS_BAR = {torch.float32: _OBS_BAR[torch.float32], torch.float64: 1e-12}


def _blocks_case(case, dt, dev):
    """(x (lanes, 9C + 3P), lists, mask) of Dubrovnik-356's scene at its
    true cameras and points for ``case``: as drawn, small angles (w = 0 on
    every third camera, |w| ≈ 1e-7 on the next), camera 0's pose and one
    focal length frozen by the mask, or two lanes (the second moved)."""
    from cannoles_tpu_torch.models.bal import draw_scene
    from cannoles_tpu_torch.ops import obs_products

    C, P, n_obs = 356, 226_730, 1_255_268
    sc = draw_scene(C, P, n_obs, seed=0)
    cams = sc["cams"].clone()
    if case == "small_angle":
        cams[0::3, :3] = 0.0
        cams[1::3, :3] = torch.tensor([6e-8, -5e-8, 4e-8], dtype=cams.dtype)
    x = torch.cat([cams.reshape(-1), sc["pts"].reshape(-1)]).to(dtype=dt, device=dev)[None]
    if case == "two_lanes":
        g = torch.Generator(device=dev).manual_seed(22)
        x = torch.cat([x, x + 1e-3 * torch.randn(x.shape, generator=g, dtype=dt, device=dev)])
    mask = None
    if case == "masked":
        mask = torch.ones((C, 9), dtype=dt, device=dev)
        mask[0, :6] = 0.0
        mask[7, 6] = 0.0
    return x, obs_products.lists(sc["cam_idx"].to(dev), sc["pt_idx"].to(dev), C, P), mask


@pytest.mark.parametrize("case", ["scene", "small_angle", "masked", "two_lanes"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_obs_blocks_kernel_matches_plain_at_dubrovnik_size_on_card(cuda, dtype, case):
    """The blocks kernel at BAL Dubrovnik-356's lists (356 cameras, 226,730
    points, 1,255,268 observations): A, Bm and W against the plain version
    (jacfwd, the mask, an einsum) within ``_BLOCKS_BAR`` of each
    observation's block magnitude, bit-equal across two launches, each
    launch counted, the masked columns zero."""
    from cannoles_tpu_torch.models.bal import snavely_project
    from cannoles_tpu_torch.ops import obs_blocks

    dt = getattr(torch, dtype)
    x, sl, mask = _blocks_case(case, dt, cuda)
    before = _n("obs_blocks")
    k1 = obs_blocks.blocks(snavely_project, x, sl, 9, mask)
    k2 = obs_blocks.blocks(snavely_project, x, sl, 9, mask)
    ref = obs_blocks.plain_blocks(snavely_project, x, sl, 9, mask)
    torch.cuda.synchronize()
    assert _n("obs_blocks") == before + 2
    for a, b, r, shape in zip(k1, k2, ref, ((2, 9), (2, 3), (9, 3))):
        assert a.shape == r.shape == (x.shape[0], sl.n_obs, *shape) and a.is_contiguous()
        assert torch.equal(a, b)
        mag = r.abs().flatten(2).amax(-1).clamp_min(torch.finfo(dt).tiny)
        worst = float(((a - r).abs().flatten(2).amax(-1) / mag).max())
        assert worst <= _BLOCKS_BAR[dt], (shape, worst)
    if mask is not None:
        on0 = sl.cam_idx == 0
        assert bool((k1[0][:, on0][..., :6] == 0).all()) and bool((k1[2][:, on0][:, :, :6] == 0).all())
    with pytest.raises(ValueError, match="must be"):
        obs_blocks.blocks(snavely_project, x[:, :-3], sl, 9, mask)


def test_list_route_solve_on_card_takes_the_obs_blocks_kernel(cuda, monkeypatch):
    """One LM solve of a tenth of Dubrovnik-356 (36 cameras, 22,673 points,
    125,527 observations, float32) on the card: every block evaluation a
    launch of the blocks kernel ("obs_blocks" = ("obs_blocks", "calls") >
    0); with the plain blocks on the card the same status and the cost
    within 1e-3 of it (the cell's cost_gap limit: both stop at the stated
    √eps-relative first-order test, in other roundings)."""
    from cannoles_tpu_torch.core.ba import SchurBASolver
    from cannoles_tpu_torch.core.solver import _add_batch_axis
    from cannoles_tpu_torch.models.bal import bal_scene
    from cannoles_tpu_torch.ops import obs_blocks

    C, P = 36, 22_673
    pb, _ = bal_scene(C, P, 125_527, seed=0, dtype=torch.float32, device=cuda)
    data = _add_batch_axis(pb.data, cuda)

    def solve():
        s = SchurBASolver(pb, C, P, method="lm", use_initial_multiplier=True)
        st = s.solve(max_iter=50)
        return st, 0.5 * float((pb.F(s.last_state.x, data).double() ** 2).sum())

    c0 = segments.counters()
    st, f = solve()
    c1 = segments.counters()
    calls = c1[("obs_blocks", "calls")] - c0[("obs_blocks", "calls")]
    assert calls > 0 and c1["obs_blocks"] - c0["obs_blocks"] == calls
    plain = obs_blocks.plain_blocks
    monkeypatch.setattr(obs_blocks, "blocks", lambda project, x, sl, cd, mask=None: plain(project, x, sl, cd, mask))
    st_plain, f_plain = solve()
    assert segments.counters()["obs_blocks"] == c1["obs_blocks"]
    assert st.status == st_plain.status == "first_order"
    assert abs(f - f_plain) <= 1e-3 * f_plain
