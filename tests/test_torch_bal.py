"""PyTorch port, BAL bundle adjustment on an observation list
(``models/bal.py``, the list route of ``core/ba.py``, ``ops/schur_pairs.py``,
``ops/obs_products.py``, ``ops/obs_blocks.py``) against the plain float64 reference
``tests/bal_plain.py`` on the CPU.

Scenes of 5 cameras, 80 points and 350 observations in float64; the list
route on a full-visibility 6-parameter list against the grid route, which
``test_torch_ba_schur.py`` holds to the JAX package.
"""

import bz2
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import bal_plain as bp  # noqa: E402

from cannoles_tpu_torch import nls_problem  # noqa: E402
from cannoles_tpu_torch.core import segments  # noqa: E402
from cannoles_tpu_torch.core.ba import SchurBASolver  # noqa: E402
from cannoles_tpu_torch.core.solver import _add_batch_axis  # noqa: E402
from cannoles_tpu_torch.models.ba_large import large_bundle_adjustment, project_point  # noqa: E402
from cannoles_tpu_torch.models.bal import (  # noqa: E402
    bal_problem,
    bal_scene,
    draw_scene,
    read_bal,
    snavely_project,
    write_bal,
)
from cannoles_tpu_torch.ops import _native, obs_blocks, obs_products, schur_pairs  # noqa: E402

C, P, N_OBS = 5, 80, 350
F64 = torch.float64


def _scene(seed=1, dtype=F64):
    pb, x_true = bal_scene(C, P, N_OBS, seed=seed, dtype=dtype, device="cpu")
    return pb, x_true, bp.scene(pb, C, P)


def _batched(pb):
    return _add_batch_axis(pb.data, "cpu")


def test_scene_counts_and_tracks():
    sc = draw_scene(C, P, N_OBS, seed=4)
    ci, pi = sc["cam_idx"], sc["pt_idx"]
    assert ci.shape == (N_OBS,) and sc["cams"].shape == (C, 9) and sc["pts"].shape == (P, 3)
    k = torch.bincount(pi, minlength=P)
    assert int(k.min()) >= 2 and int(k.sum()) == N_OBS
    assert torch.unique(ci * P + pi).numel() == N_OBS  # each camera sees a point once
    assert bool((torch.diff(ci * P + pi) > 0).all())  # ordered by camera, then point
    big = draw_scene(40, 3000, 16608, seed=0)  # Dubrovnik-356's mean track length, 5.536
    assert int(torch.bincount(big["pt_idx"]).sum()) == 16608 and big["cam_idx"].max() == 39
    with pytest.raises(ValueError, match="n_obs"):
        draw_scene(C, P, P, seed=0)


def test_snavely_projection_and_blocks_against_plain():
    pb, _, sc = _scene()
    x = pb.x0 + 1e-3 * torch.randn(pb.nvar, generator=torch.Generator().manual_seed(0), dtype=F64)
    np.testing.assert_allclose(pb.F(x[None], _batched(pb))[0].numpy(), bp.residual(x, sc).numpy(), rtol=0, atol=1e-12)
    cams, pts = bp.split(x, C)
    np.testing.assert_allclose(snavely_project(cams[:, None], pts[None]).numpy(),
                               bp.project(cams[:, None].expand(C, P, 9), pts[None].expand(C, P, 3)).numpy(),
                               rtol=1e-14, atol=1e-10)
    A, Bm = obs_blocks.jacfwd_blocks(snavely_project, x[None], C, P, 9, sc["cam_idx"], sc["pt_idx"])
    Ar, Br = bp.blocks(x, sc)
    np.testing.assert_allclose(A[0].numpy(), Ar.numpy(), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(Bm[0].numpy(), Br.numpy(), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(pb.c_shifted(x[None], _batched(pb))[0].numpy(), bp.cons(x, sc).numpy(),
                               rtol=0, atol=1e-12)
    # the small-angle branch: a camera with w = 0 projects X + t
    cam = torch.tensor([0, 0, 0, 0.1, -0.2, -5.0, 800.0, 0.0, 0.0], dtype=F64)
    pt = torch.tensor([0.3, 0.4, 0.0], dtype=F64)
    np.testing.assert_allclose(snavely_project(cam, pt).numpy(), [800 * 0.4 / 5, 800 * 0.2 / 5], atol=1e-12)


@pytest.mark.parametrize("method", ["gauss_newton", "lm"])
def test_one_list_step_matches_dense_normal_equations(method):
    pb, _, sc = _scene()
    s = SchurBASolver(pb, C, P, method=method)
    st = s._init_state(pb.x0[None], pb.y0[None], s.make_config(), _batched(pb))
    st = st._replace(delta=torch.full_like(st.delta, 1e-2), damp=torch.full_like(st.damp, 0.5))
    rho = 1e-3
    zx, ok, _ = s._solve_with_blocks(st, torch.tensor([rho], dtype=F64), s._precompute(st))
    assert bool(ok[0])
    x = st.x[0]
    J, Jc = bp.dense_jacobian(x, sc), bp.cons_jac(x, sc)
    reg = rho + (0.5 if method == "lm" else 0.0)
    K = reg * torch.eye(pb.nvar, dtype=F64) + J.T @ J + Jc.T @ Jc / 1e-2
    z = torch.linalg.solve(K, s._rhs(st)[0])
    assert float((zx[0] - z).abs().max()) <= 1e-10 * float(z.abs().max())


def test_whole_lm_solve_reaches_the_reference_optimum():
    pb, _, sc = _scene()
    s = SchurBASolver(pb, C, P, method="lm")
    c0 = segments.counters()
    st = s.solve(max_iter=50)
    c1 = segments.counters()
    assert st.status == "first_order", st.status
    # every ρ attempt assembles one camera system, and each sums every pair
    assemble = c1[("schur", "assemble")] - c0.get(("schur", "assemble"), 0)
    assert assemble == st.solver_specific["nfact"] == int(s.last_state.nfact[0])
    pairs = schur_pairs.plan(sc["cam_idx"], sc["pt_idx"], C).n_pairs
    assert c1[("schur", "pairs")] - c0.get(("schur", "pairs"), 0) == assemble * pairs
    assert c1["schur_pairs"] == c0["schur_pairs"]  # the plain version on the CPU
    x_ref, f_ref = bp.solve(pb.x0, sc)
    x = torch.as_tensor(st.solution)
    # the gauge is met only to the stopping test's tolerance: compare what it leaves alone
    assert abs(bp.cost(x, sc) - f_ref) <= 1e-12 * f_ref
    assert float((bp.residual(x, sc) - bp.residual(x_ref, sc)).abs().max()) < 1e-5
    ls = s.last_state
    tol = bp.tolerance(pb.x0, sc, float(torch.finfo(F64).eps))
    assert bp.measure(ls.x[0], ls.r[0], ls.lam[0], sc) <= tol


def test_solve_takes_the_data_of_another_observation_set():
    pb, _, sc = _scene()
    obs2 = pb.data["obs"] + 0.5 * torch.randn(pb.data["obs"].shape, generator=torch.Generator().manual_seed(3),
                                              dtype=F64)
    s = SchurBASolver(pb, C, P, method="lm")
    a = s.solve(max_iter=3, data={**pb.data, "obs": obs2})
    plan = s._plan
    pb2 = bal_problem(*bp.split(pb.x0, C), pb.data["cam_idx"], pb.data["pt_idx"], obs2, pose0=pb.data["pose0"],
                      base2=pb.data["base2"], dtype=F64, device="cpu")
    b = SchurBASolver(pb2, C, P, method="lm").solve(max_iter=3)
    assert (a.iter, a.solver_specific["nfact"]) == (b.iter, b.solver_specific["nfact"])
    np.testing.assert_array_equal(a.solution, b.solution)
    s.solve(max_iter=1)
    assert s._plan is plan  # one structure, one plan


def _listed(pb_grid, n_cams, n_pts):
    """The grid problem of ``large_bundle_adjustment`` as a full-visibility
    observation list of the 6-parameter pinhole (same residual order)."""
    d = pb_grid.data
    ci = torch.arange(n_cams).repeat_interleave(n_pts)
    pi = torch.arange(n_pts).repeat(n_cams)

    def residual(x, dd):
        cams = x[: 6 * n_cams].reshape(n_cams, 6)
        pts = x[6 * n_cams:].reshape(n_pts, 3)
        return (project_point(cams[dd["cam_idx"]], pts[dd["pt_idx"]]) - dd["obs"]).reshape(-1)

    data = {"cam_idx": ci, "pt_idx": pi, "obs": d["obs"].reshape(-1, 2), "pose0": d["pose0"], "base2": d["base2"]}
    return nls_problem(residual, pb_grid.x0, pb_grid.nequ, pb_grid.cons, pb_grid.lcon, pb_grid.ucon, data=data,
                       device="cpu")


@pytest.mark.parametrize("method", ["gauss_newton", "lm"])
def test_full_visibility_list_reproduces_the_grid_route(method):
    pg, _ = large_bundle_adjustment(4, 30, noise=0.01, seed=2, dtype=F64, device="cpu")
    pl = _listed(pg, 4, 30)
    a = SchurBASolver(pg, 4, 30, method=method).solve(max_iter=12)
    b = SchurBASolver(pl, 4, 30, method=method).solve(max_iter=12)
    assert (a.status, a.iter) == (b.status, b.iter)
    assert a.solver_specific["nfact"] == b.solver_specific["nfact"]
    assert a.solver_specific["nbk"] == b.solver_specific["nbk"]
    assert np.abs(a.solution - b.solution).max() <= 1e-10 * max(np.abs(a.solution).max(), 1.0)


def test_pair_twin_against_a_dense_einsum():
    sc = draw_scene(C, P, N_OBS, seed=5)
    ci, pi = sc["cam_idx"], sc["pt_idx"]
    g = torch.Generator().manual_seed(7)
    for cd in (9, 6):
        X = torch.randn((N_OBS, cd, 3), generator=g, dtype=F64)
        W = torch.randn((N_OBS, cd, 3), generator=g, dtype=F64)
        pp = schur_pairs.plan(ci, pi, C)
        T = schur_pairs.accumulate(X, W, pp)
        # dense: scatter to the (C, P) grid and sum over points
        Xg = torch.zeros(C, P, cd, 3, dtype=F64)
        Wg = torch.zeros(C, P, cd, 3, dtype=F64)
        Xg[ci, pi], Wg[ci, pi] = X, W
        dense = torch.einsum("cpik,dpjk->cdij", Xg, Wg)
        assert bool((pp.block_cam[:, 0] >= pp.block_cam[:, 1]).all())
        ref = dense[pp.block_cam[:, 0], pp.block_cam[:, 1]]
        np.testing.assert_allclose(T.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
        # every lower block with a shared point is listed once
        shared = torch.einsum("cp,dp->cd", (Xg[..., 0, 0] != 0).to(F64), (Xg[..., 0, 0] != 0).to(F64))
        assert pp.n_blocks == int(torch.tril(shared > 0).sum())
        k = torch.bincount(pi, minlength=P)
        assert pp.n_pairs == int((k * (k + 1) // 2).sum())
    seg = schur_pairs.segment_sum(X.reshape(N_OBS, -1), ci, C)
    np.testing.assert_allclose(seg.numpy(), torch.zeros(C, 18, dtype=F64).index_add_(0, ci, X.reshape(N_OBS, -1)),
                               rtol=1e-14)
    with pytest.raises(ValueError, match="twice"):
        schur_pairs.plan(torch.tensor([0, 0]), torch.tensor([1, 1]), 2)


def test_constraints_on_points_are_rejected():
    pb, _, _ = _scene()
    bad = dataclasses.replace(pb, cons=lambda x, d: (x[-1] - 1.0).reshape(1), ncon=1,
                              lcon=torch.zeros(1, dtype=F64), ucon=torch.zeros(1, dtype=F64),
                              y0=torch.zeros(1, dtype=F64))
    with pytest.raises(ValueError, match="camera block"):
        SchurBASolver(bad, C, P)
    with pytest.raises(ValueError, match="BA layout"):
        SchurBASolver(pb, C + 1, P)
    with pytest.raises(ValueError, match="n_obs"):
        SchurBASolver(dataclasses.replace(pb, nequ=pb.nequ - 2), C, P)


def test_the_pair_library_is_built_only_on_a_card():
    pb, _, _ = _scene()
    SchurBASolver(pb, C, P, method="lm").solve(max_iter=1)
    assert "schur_pairs.cu" not in _native._LIBS and "schur_pairs.cu" not in _native._SOURCES
    assert (_native.CSRC / "schur_pairs.cu").exists()


@pytest.mark.parametrize("suffix", [".txt", ".bz2"])
def test_bal_files_round_trip(tmp_path, suffix):
    sc = draw_scene(C, P, N_OBS, seed=6)
    obs = sc["u"] + 0.25
    path = tmp_path / f"problem-{C}-{P}-pre{suffix}"
    write_bal(path, sc["cams"], sc["pts"], sc["cam_idx"], sc["pt_idx"], obs)
    if suffix == ".bz2":
        assert bz2.open(path, "rt").readline().split() == [str(C), str(P), str(N_OBS)]
    got = read_bal(path)
    np.testing.assert_array_equal(got["cams"], sc["cams"].numpy())
    np.testing.assert_array_equal(got["pts"], sc["pts"].numpy())
    np.testing.assert_array_equal(got["cam_idx"], sc["cam_idx"].numpy())
    np.testing.assert_array_equal(got["pt_idx"], sc["pt_idx"].numpy())
    np.testing.assert_array_equal(got["obs"], obs.numpy())
    pb = bal_problem(got["cams"], got["pts"], got["cam_idx"], got["pt_idx"], got["obs"], dtype=F64, device="cpu")
    assert (pb.nvar, pb.nequ, pb.ncon) == (9 * C + 3 * P, 2 * N_OBS, 7)
    assert float(pb.c_shifted(pb.x0[None], _batched(pb)).abs().max()) < 1e-12  # the gauge of the start
    bad = tmp_path / "short.txt"
    bad.write_text(f"{C} {P} 2\n0 0 1.0 2.0\n")
    with pytest.raises(ValueError):
        read_bal(bad)


def test_schur_spans_in_a_profiled_solve():
    from torch.profiler import ProfilerActivity, profile

    pb, _, _ = _scene()
    s = SchurBASolver(pb, C, P, method="lm")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st = s.solve(max_iter=1)
    names = {e.key for e in prof.key_averages()}
    spans = {"cannoles.schur.blocks", "cannoles.schur.assemble", "cannoles.schur.factor", "cannoles.schur.solve"}
    assert spans <= names
    counts = {e.key: e.count for e in prof.key_averages() if e.key in spans}
    assert counts["cannoles.schur.assemble"] == st.solver_specific["nfact"]


def test_list_products_from_the_blocks_equal_the_transforms():
    """On a list the solver's products come from the per-observation blocks:
    J v, Jᵀw, Jc v and Jcᵀw equal the problem's torch.func products, and the
    blocks at one iterate are worked out once for all of them."""
    pb, _, _ = _scene()
    s = SchurBASolver(pb, C, P, method="lm")
    d = _batched(pb)
    g = torch.Generator().manual_seed(9)
    x = pb.x0[None] + 1e-3 * torch.randn((1, pb.nvar), generator=g, dtype=F64)
    v = torch.randn((1, pb.nvar), generator=g, dtype=F64)
    w, y = torch.randn((1, pb.nequ), generator=g, dtype=F64), torch.randn((1, 7), generator=g, dtype=F64)
    lp = s.problem
    for got, want in ((lp.jprod_res(x, v, d), pb.jprod_res(x, v, d)), (lp.jtprod_res(x, w, d), pb.jtprod_res(x, w, d)),
                      (lp.jprod_cons(x, v, d), pb.jprod_cons(x, v, d)),
                      (lp.jtprod_cons(x, y, d), pb.jtprod_cons(x, y, d))):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    A, _ = lp.blocks(x, d)
    assert lp.blocks(x, d)[0] is A and lp.blocks(x.clone(), d)[0] is not A
    assert lp.nvar == pb.nvar and lp.F is not None


@pytest.mark.parametrize("shuffled", [False, True])
def test_segment_lists_equal_a_stable_sort_reference(shuffled):
    """Each camera's and each point's observations, in ascending order: on
    the scene's camera-sorted list and on the same list shuffled (camera
    segments scattered too)."""
    sc = draw_scene(C, P, N_OBS, seed=5)
    ci, pi = sc["cam_idx"], sc["pt_idx"]
    if shuffled:
        perm = torch.randperm(N_OBS, generator=torch.Generator().manual_seed(2))
        ci, pi = ci[perm], pi[perm]
    sl = obs_products.lists(ci, pi, C, P)
    for order, start, index, n in ((sl.cam_order, sl.cam_start, ci, C), (sl.pt_order, sl.pt_start, pi, P)):
        assert order.dtype == start.dtype == torch.int32
        ref = [o for seg in range(n) for o in range(N_OBS) if int(index[o]) == seg]
        counts = [sum(1 for o in range(N_OBS) if int(index[o]) == seg) for seg in range(n)]
        assert order.tolist() == ref
        assert start.tolist() == np.concatenate([[0], np.cumsum(counts)]).tolist()
    assert torch.equal(sl.cam, ci.to(torch.int32)) and torch.equal(sl.pt, pi.to(torch.int32))
    assert sl.cam_idx is ci and sl.pt_idx is pi and (sl.n_cams, sl.n_pts, sl.n_obs) == (C, P, N_OBS)


def test_obs_products_take_the_plain_version_on_the_cpu():
    """On CPU tensors each kind is its plain version, bit for bit; each call
    is counted under its kind and no launch is counted; a list-route solve
    calls every kind, and the kernel's library is not built."""
    pb, _, _ = _scene()
    s = SchurBASolver(pb, C, P, method="lm")
    d = _batched(pb)
    g = torch.Generator().manual_seed(12)
    x = pb.x0[None] + 1e-3 * torch.randn((1, pb.nvar), generator=g, dtype=F64)
    A, Bm = s.problem.blocks(x, d)
    _, sl = s._structure(d)
    X = torch.randn((1, N_OBS, 9, 3), generator=g, dtype=F64)
    cases = {
        "jv": (A, Bm, torch.randn((1, pb.nvar), generator=g, dtype=F64), sl),
        "jtw": (A, Bm, torch.randn((1, pb.nequ), generator=g, dtype=F64), sl),
        "reduce": (X, torch.randn((1, P, 3), generator=g, dtype=F64), sl),
        "lift": (X, torch.randn((1, C, 9), generator=g, dtype=F64), sl),
        "uv": (A, Bm, sl),
    }
    for kind, args in cases.items():
        c0 = segments.counters()
        got = getattr(obs_products, kind)(*args)
        want = getattr(obs_products, f"plain_{kind}")(*args)
        c1 = segments.counters()
        for a, b in zip(got if kind == "uv" else (got,), want if kind == "uv" else (want,)):
            assert torch.equal(a, b), kind
        assert c1[("obs_products", kind)] == c0[("obs_products", kind)] + 1
        assert c1["obs_products"] == c0["obs_products"]
    c0 = segments.counters()
    s.solve(max_iter=1)
    c1 = segments.counters()
    assert all(c1[("obs_products", k)] > c0[("obs_products", k)] for k in obs_products.KINDS)
    assert c1["obs_products"] == c0["obs_products"]
    assert "obs_products.cu" not in _native._LIBS and "obs_products.cu" not in _native._SOURCES
    assert (_native.CSRC / "obs_products.cu").exists()


def _blocks_before_the_kernel(project, x, C_, P_, cd, ci, pi, mask):
    """The list route's blocks as ``core/ba.py`` formed them before
    ``ops/obs_blocks.py``: vmap(vmap(jacfwd)) over the gathered cameras and
    points, the mask, W by an einsum."""
    from torch.func import jacfwd, vmap

    Bt = x.shape[0]
    cams = x[:, : cd * C_].reshape(Bt, C_, cd)[:, ci]
    pts = x[:, cd * C_:].reshape(Bt, P_, 3)[:, pi]

    def jac_one(cam, pt):
        J = jacfwd(lambda v: project(v[:cd], v[cd:]))(torch.cat([cam, pt]))
        return J[:, :cd], J[:, cd:]

    A, Bm = vmap(vmap(jac_one))(cams, pts)
    A, Bm = A.to(x.dtype), Bm.to(x.dtype)
    if mask is not None:
        A = A * mask[ci][None, :, None, :]
    return A, Bm, torch.einsum("boki,bokj->boij", A, Bm)


@pytest.mark.parametrize("case", ["f64", "f64_masked", "f32_two_lanes", "pinhole_masked"])
def test_plain_blocks_equal_the_blocks_before_the_kernel(case):
    """``obs_blocks.plain_blocks`` (and ``blocks`` on CPU tensors) give the
    blocks the list route formed before the kernel, bit for bit: Snavely's
    camera in float64, with a frozen-coordinate mask, in float32 on two
    lanes, and the 6-parameter pinhole with a mask."""
    g = torch.Generator().manual_seed(31)
    sc = draw_scene(C, P, N_OBS, seed=8)
    ci, pi = sc["cam_idx"], sc["pt_idx"]
    dt = torch.float32 if case == "f32_two_lanes" else F64
    if case == "pinhole_masked":
        project, cd = project_point, 6
        cams = torch.cat([0.1 * torch.randn((C, 3), generator=g, dtype=F64),
                          torch.tensor([0.0, 0.0, -8.0], dtype=F64).expand(C, 3)], -1)
    else:
        project, cd, cams = snavely_project, 9, sc["cams"]
    x = torch.cat([cams.reshape(-1), sc["pts"].reshape(-1)]).to(dt)[None]
    if case == "f32_two_lanes":
        x = torch.cat([x, x + 1e-3 * torch.randn(x.shape, generator=g).to(dt)])
    mask = None
    if case.endswith("masked"):
        mask = torch.ones(C, cd, dtype=dt)
        mask[0, :6] = 0.0
        mask[2, 4] = 0.0
    sl = obs_products.lists(ci, pi, C, P)
    want = _blocks_before_the_kernel(project, x, C, P, cd, ci, pi, mask)
    for got in (obs_blocks.plain_blocks(project, x, sl, cd, mask), obs_blocks.blocks(project, x, sl, cd, mask)):
        assert len(got) == 3
        for a, b in zip(got, want):
            assert a.dtype == dt and torch.equal(a, b)
    if mask is not None:
        assert bool((want[0][:, ci == 0][..., :6] == 0).all())


def test_obs_blocks_count_calls_and_no_launch_on_the_cpu():
    """A list-route solve on the CPU counts each block evaluation as a call
    and launches nothing; the kernel's library is not built; the Schur
    assembly's W is the one kept beside A and Bm."""
    pb, _, _ = _scene()
    s = SchurBASolver(pb, C, P, method="lm")
    d = _batched(pb)
    c0 = segments.counters()
    st = s.solve(max_iter=3)
    c1 = segments.counters()
    assert c1[("obs_blocks", "calls")] - c0[("obs_blocks", "calls")] >= st.iter
    assert c1["obs_blocks"] == c0["obs_blocks"]
    assert "obs_blocks.cu" not in _native._LIBS and "obs_blocks.cu" not in _native._SOURCES
    assert (_native.CSRC / "obs_blocks.cu").exists()
    x = pb.x0[None].clone()
    got = s.problem._at(x, d)
    U, V, W = s._blocks(x, d)
    assert W is got["W"] and s.problem._at(x, d) is got
    assert torch.equal(W, torch.einsum("boki,bokj->boij", got["A"], got["Bm"]))


def test_own_projection_never_routes_to_the_kernel(monkeypatch):
    """The kernel's route is chosen by the projection: off the CPU (here a
    meta tensor stands for a card's), a user's own projection, even one that
    computes Snavely's, and the 6-parameter pinhole take the plain version,
    and ``snavely_project`` alone reaches the launch; a solver built with its
    own projection solves as the default one on the CPU."""
    pb, _, _ = _scene()
    d = _batched(pb)

    def own(cam, pt):
        return snavely_project(cam, pt)

    class Launch(Exception):
        pass

    def launch(dtype):
        raise Launch(dtype)

    took = []
    monkeypatch.setattr(obs_blocks, "plain_blocks", lambda project, *a: took.append(project))
    monkeypatch.setattr(obs_blocks, "_function", launch)
    s = SchurBASolver(pb, C, P, method="lm", project=own)
    _, sl = s._structure(d)
    meta = sl._replace(cam=sl.cam.to("meta"), pt=sl.pt.to("meta"))
    x = pb.x0[None].to("meta")
    obs_blocks.blocks(own, x, meta, 9)
    obs_blocks.blocks(project_point, x, meta, 6)
    assert took == [own, project_point]
    with pytest.raises(Launch):
        obs_blocks.blocks(snavely_project, x, meta, 9)
    assert took == [own, project_point]
    monkeypatch.undo()
    c0 = segments.counters()
    st = SchurBASolver(pb, C, P, method="lm", project=own).solve(max_iter=2)
    assert segments.counters()[("obs_blocks", "calls")] > c0[("obs_blocks", "calls")]
    ref = SchurBASolver(pb, C, P, method="lm").solve(max_iter=2)
    np.testing.assert_array_equal(st.solution, ref.solution)
