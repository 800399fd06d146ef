"""Smoke run of the solver on one NVIDIA GPU, through its public entry points.

    python chip_smoke.py           # phases 1-4 on one card
    python chip_smoke.py --four    # phase 5 only: the 4-card mesh

Everything runs in this one process (a second JAX process could not get the
card's memory). With no GPU the script exits non-zero at once; it never
falls back to the CPU. Phases, in order:

  1. small-size correctness against the dense np.kron oracle: the SPD
     Lanczos path and the nonsymmetric Arnoldi path, each also solved on the
     CPU backend in-process for an iteration-count comparison;
  2. the north-star flagship (experiments/northstar.py recipe): d=10,
     n=131072, kappa=1e6, m=2048 deflation, kmax=512, native f64, certified
     on device by the bound and the basis-free cross-check;
  3. the one-jit solver at real width (d=10, n=16384, kappa=1e4) with its
     device cross-check, plus the XLA banded SpMV and Lanczos step timings;
  4. the nonsymmetric and rank-R paths once each, the df64 and recorded
     block paths at moderate size, and the f32 exactness guards (the EFT
     self-check and a pinned-precision pair GEMM that TF32 would break).

A failed phase raises and the script exits non-zero; the last stdout line is
the JSON device record only when every phase passed. Earlier lines give the
card's name and power limit, the JAX version, devices, XLA_FLAGS, the
compile-cache directory, and per phase its wall time, compile time,
iterations, status, residual or certificate, tolerance and peak device bytes.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

TOL = 1e-8

# phase sizes (keyword arguments of the phase functions, which take them
# as arguments so the CPU tests can run them tiny)
FLAGSHIP = dict(d=10, n=131072, kappa=1e6, m=2048, kmax=512)
REAL_WIDTH = dict(d=10, n=16384, kappa=1e4, kmax=480)
SPMV_SHAPE = dict(d=8, n=1 << 20)
STEP_SHAPE = dict(d=10, n=131072)
NONSYM = dict(d=10, n=16384, kappa=1e4, kmax=384, tmax=801, check_every=16)
BLOCK = dict(d=10, n=10240, kappa=1e4, rank=4, kmax=160)
DF64 = dict(d=10, n=16384, kappa=1e4, m=128, kmax=512)
BLOCK_RECORDED = dict(d=10, n=4096, kappa=1e3, rank=2, kmax=48)


class PhaseFailed(AssertionError):
    """A phase's result did not meet its contract."""


def check(cond, msg: str):
    if not cond:
        raise PhaseFailed(msg)


def gpu_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output (raises if absent)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu():
    """The first GPU device; SystemExit when JAX finds none."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU found (jax.devices() = {devs}); "
            "this script runs only on an NVIDIA GPU")
    return devs[0]


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling since reset()."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration

    def reset(self):
        self.total = 0.0


def peak_device_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def run_phase(name: str, fn, clock: CompileClock, **kw) -> dict:
    """Run one phase, print its record, return its metrics."""
    clock.reset()
    t0 = time.perf_counter()
    out = fn(**kw)
    wall = time.perf_counter() - t0
    print(f"[{name}] PASS wall_s={wall} compile_s={clock.total} "
          f"peak_device_bytes={peak_device_bytes()}", flush=True)
    for key, val in out.items():
        print(f"[{name}]   {key} = {val}", flush=True)
    return out


def _estimate(res) -> float:
    """The last recorded relative-residual estimate of a SolveResult."""
    hist = np.asarray(res.relative_residual)[: int(res.niterations) + 1]
    fin = hist[np.isfinite(hist)]
    return float(fin[-1]) if fin.size else float("inf")


# ---------------------------------------------------------------- phase 1


def phase_small(d: int = 3, n: int = 30) -> dict:
    """SPD Lanczos (BH tables) and nonsymmetric Arnoldi (Stenger rank 601)
    against the dense np.kron oracle, with an in-process CPU run of each."""
    import jax
    import jax.numpy as jnp

    import tensorkrylov as tk
    from tensorkrylov.types import Status

    def spd():
        op = tk.laplace(d, n)
        sys_ = tk.TensorizedSystem.create(op, tk.random_rhs(d, n, seed=7))
        res = tk.solve_tensorized_system(sys_, nmax=n, tol=TOL)
        return op, np.asarray(sys_.b), res

    def nonsym():
        op = tk.conv_diff(d, n)
        b = tk.random_rhs(d, n, seed=7)
        b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
        cfg = tk.SolverConfig(kmax=n, tol=TOL, orth="arnoldi", tmax=601)
        return op, np.asarray(b), tk.solve(op, b, cfg)

    out = {}
    cpu = jax.devices("cpu")[0]
    for label, build in (("spd", spd), ("nonsym", nonsym)):
        op, b, res = build()
        with jax.default_device(cpu):
            _, _, res_cpu = build()
        status, k = int(res.status), int(res.niterations)
        k_cpu = int(res_cpu.niterations)
        true = tk.kron_residual_dense(op, res.x, b)
        est = _estimate(res)
        out[label] = dict(status=status, iterations=k, cpu_iterations=k_cpu,
                          estimate=est, true_residual=true, tol=TOL,
                          nonsym_solve_impl=res.config.nonsym_solve_impl)
        check(status == Status.CONVERGED, f"{label}: status {status}")
        check(true <= TOL, f"{label}: true residual {true} > {TOL}")
        check(abs(k - k_cpu) <= 1, f"{label}: {k} iterations vs {k_cpu} on CPU")
        check(est >= 0.1 * true, f"{label}: estimate {est} < 0.1 x true {true}")
    return out


# ---------------------------------------------------------------- phase 2


def phase_flagship(d: int, n: int, kappa: float, m: int, kmax: int,
                   seed: int = 1234, mesh=None, comm: str = "gspmd") -> dict:
    """The north-star deflated solve, certified on device (storage='full',
    native f64): bound < tol and cross-check <= max(tol, its floor)."""
    from tensorkrylov.experiments import northstar

    op, b, _ = northstar.flagship_problem(d, n, kappa, seed)
    t0 = time.perf_counter()
    basis = northstar.flagship_basis(op, m)
    t_basis = time.perf_counter() - t0
    res, err = northstar.solve_flagship(
        op, b, basis, kmax=kmax, tol=TOL, storage="full", final="device",
        mesh=mesh, comm=comm, verbose=False)
    bound = res.certified_bound[-1] if res.certified_bound else float("inf")
    meas, floor = res.measured_cp_residual, res.cp_residual_floor
    out = dict(status=res.status, iterations=res.niterations,
               checkpoints=res.checkpoints, certified_bound=bound,
               estimate=res.relative_residual[-1] if res.relative_residual
               else None,
               measured_cp_residual=meas, cp_residual_floor=floor, tol=TOL,
               orthogonality_drift=res.orthogonality_drift,
               basis_setup_s=t_basis, cross_check_error=err)
    check(bound < TOL, f"flagship: certified bound {bound} >= {TOL}")
    check(meas is not None, f"flagship: no device cross-check ({err})")
    check(meas <= max(TOL, floor),
          f"flagship: cross-check {meas} > max({TOL}, floor {floor})")
    check(res.orthogonality_drift is not None
          and np.isfinite(res.orthogonality_drift),
          "flagship: orthogonality drift not reported")
    return out


# ---------------------------------------------------------------- phase 3


def real_width_problem(d: int, n: int, kappa: float, seed: int = 1234):
    from tensorkrylov.experiments import northstar

    op, b, _ = northstar.flagship_problem(d, n, kappa, seed)
    return op, b


def real_width_config(kmax: int):
    import tensorkrylov as tk

    return tk.SolverConfig(kmax=kmax, tol=TOL, orth="lanczos_reorth",
                           eigh_impl="dense")


def phase_real_width(d: int, n: int, kappa: float, kmax: int,
                     spmv_shape: dict, step_shape: dict,
                     spmv_iters: int = 200) -> dict:
    """tk.solve (one jitted while_loop) at real width with the device
    cross-check and the compiled program's memory analysis, then the XLA
    SpMV and Lanczos-step timings (bytes counted as 5·d·n·4 per apply)."""
    import jax

    import bench
    import tensorkrylov as tk
    from tensorkrylov.coeffs.tables import load_tables
    from tensorkrylov.solver import _resolve_config, _solve_jit
    from tensorkrylov.types import Status
    from tensorkrylov.utils.cp import cp_residual_cross_check_device

    op, b = real_width_problem(d, n, kappa)
    cfg = real_width_config(kmax)
    tables = load_tables(dtype=cfg.proj_dtype)
    compiled = _solve_jit.lower(op, b, tables,
                                _resolve_config(cfg, op)).compile()
    mem = compiled.memory_analysis()
    t0 = time.perf_counter()
    res = tk.solve(op, b, cfg, tables)
    jax.block_until_ready(res.x.factors)
    t_solve = time.perf_counter() - t0
    est = _estimate(res)
    chk = cp_residual_cross_check_device(
        op, np.asarray(res.x.weights, np.float64), res.x.factors, b)
    b_norm = float(np.prod(np.linalg.norm(np.asarray(b), axis=1)))
    meas, floor = chk.value / b_norm, chk.floor / b_norm

    t_spmv, nnz = bench.bench_spmv(tk, jax, jax.numpy, iters=spmv_iters,
                                   **spmv_shape)
    t_step = bench.bench_lanczos_step(tk, jax, jax.numpy, **step_shape)
    out = dict(
        status=int(res.status), iterations=int(res.niterations),
        solve_s=t_solve, estimate=est, measured_cp_residual=meas,
        cp_residual_floor=floor, tol=TOL,
        memory_analysis=None if mem is None else dict(
            argument_bytes=mem.argument_size_in_bytes,
            output_bytes=mem.output_size_in_bytes,
            temp_bytes=mem.temp_size_in_bytes,
            generated_code_bytes=mem.generated_code_size_in_bytes),
        spmv_shape=spmv_shape, spmv_s_per_apply=t_spmv,
        spmv_bytes_per_s=bench.spmv_bytes(**spmv_shape) / t_spmv,
        spmv_gnnz_per_s=nnz / t_spmv / 1e9,
        lanczos_step_shape=step_shape, lanczos_step_s=t_step,
        lanczos_step_spmv_bytes_per_s=bench.spmv_bytes(**step_shape) / t_step,
    )
    check(int(res.status) == Status.CONVERGED,
          f"real width: status {int(res.status)} after {int(res.niterations)}")
    check(est < TOL, f"real width: estimate {est} >= {TOL}")
    check(meas <= max(TOL, floor),
          f"real width: cross-check {meas} > max({TOL}, floor {floor})")
    return out


# ---------------------------------------------------------------- phase 4


def nonsym_eig_matches_expm(n: int = 24, tmax: int = 201) -> dict:
    """The nonsymmetric projected solve by eig and by the Taylor-expm chain
    on the default device agree (decides nonsym_solve_impl='auto')."""
    import jax.numpy as jnp

    import tensorkrylov as tk

    op = tk.conv_diff(2, n)
    b = tk.random_rhs(2, n, seed=3)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    res = {}
    for impl in ("eig", "expm"):
        cfg = tk.SolverConfig(kmax=n, tol=1e-10, orth="arnoldi", tmax=tmax,
                              nonsym_solve_impl=impl)
        res[impl] = tk.solve(op, b, cfg)
    xe, xm = (tk.cp_full(res[i].x) for i in ("eig", "expm"))
    diff = float(np.linalg.norm(xe - xm) / np.linalg.norm(xm))
    check(diff < 1e-8, f"eig vs expm solutions differ by {diff}")
    return dict(eig_vs_expm_rel_diff=diff)


def tf32_guard(n: int = 4096, cols: int = 32, seed: int = 0) -> dict:
    """f32 contractions against f64 numpy: the f32-basis projection
    (ops/orth._project_coeffs) must sit at f32 roundoff (~1e-7), not TF32's
    ~1e-3; the df64 basis Gram of an orthonormal f32-pair basis
    (df64_core._df64_gram_deviation_host) at the pair's 48-bit storage
    level (~1e-14), not at f32's ~1e-7 as when a low word is dropped."""
    import jax.numpy as jnp

    from tensorkrylov.df64_core import _df64_gram_deviation_host
    from tensorkrylov.ops.orth import _project_coeffs

    rng = np.random.default_rng(seed)
    V = rng.standard_normal((cols, 2, n)).astype(np.float32)
    u = rng.standard_normal((2, n)).astype(np.float32)
    w = np.asarray(_project_coeffs(jnp.asarray(V), jnp.asarray(u), cols,
                                   jnp.float32))
    ref = np.einsum("kdn,dn->dk", V.astype(np.float64), u.astype(np.float64))
    proj_err = float(np.max(np.abs(w - ref)) / np.max(np.abs(ref)))
    Q = np.linalg.qr(rng.standard_normal((n, cols)))[0].T       # (cols, n)
    Qh = Q.astype(np.float32)
    Ql = (Q - Qh.astype(np.float64)).astype(np.float32)
    gram_dev = _df64_gram_deviation_host(jnp.asarray(Qh), jnp.asarray(Ql),
                                         cols, 1)
    check(proj_err < 1e-5, f"f32 projection rel error {proj_err} (TF32?)")
    check(gram_dev < 1e-12, f"f32-pair Gram deviation {gram_dev}")
    return dict(f32_projection_rel_err=proj_err, pair_gram_deviation=gram_dev)


def eft_guard() -> dict:
    from tensorkrylov.ops.expansion import eft_selfcheck

    chk = eft_selfcheck()
    check(chk["composed_acc_rel"] < 1e-12,
          f"EFT self-check {chk}: f32 expansion arithmetic not exact")
    return chk


def _check_certificate(label: str, rec: dict):
    """A recording solver's certified bound must not be contradicted by the
    basis-free cross-check (converged or not)."""
    meas, bound = rec["measured_cp_residual"], rec["certified_bound"]
    check(meas is not None and bound is not None,
          f"{label}: missing cross-check or bound")
    check(meas <= max(bound, rec["cp_residual_floor"]),
          f"{label}: cross-check {meas} contradicts certified bound {bound}")


def phase_paths(nonsym: dict, block: dict, df64: dict,
                block_recorded: dict) -> dict:
    """The nonsymmetric, rank-R, df64 and recorded-block paths once each,
    each reporting its residual against its floor, plus the exactness
    guards. Nonsym and plain block must converge and meet tol by the
    cross-check; the recording paths' cross-checks must not contradict
    their certified bounds."""
    import jax

    import tensorkrylov as tk
    from tensorkrylov.experiments import config4_block, nonsym_scale
    from tensorkrylov.experiments.northstar import (
        flagship_basis, flagship_problem)
    from tensorkrylov.types import Status
    from tensorkrylov.utils.cp import cp_residual_cross_check_device

    out = {"tf32_guard": tf32_guard(), "eft_selfcheck": eft_guard(),
           "nonsym_eig_vs_expm": nonsym_eig_matches_expm()}

    # Arnoldi + Stenger at scale
    op, b, _ = nonsym_scale.nonsym_problem(
        nonsym["d"], nonsym["n"], 10.0, nonsym["kappa"], 1234)
    t0 = time.perf_counter()
    r = nonsym_scale.solve_nonsym(
        op, b, kmax=nonsym["kmax"], tol=TOL, tmax=nonsym["tmax"],
        check_every=nonsym["check_every"])
    out["nonsym"] = dict(
        shape=nonsym, status=int(r["result"].status),
        iterations=r["niterations"], estimate=r["relative_residual"],
        measured_cp_residual=r["measured_cp_residual"],
        cp_residual_floor=r["cp_residual_floor"], tol=TOL,
        wall_s=time.perf_counter() - t0)
    check(int(r["result"].status) == Status.CONVERGED,
          f"nonsym: status {int(r['result'].status)}")
    check(r["measured_cp_residual"] <= max(TOL, r["cp_residual_floor"]),
          "nonsym: cross-check above max(tol, floor)")

    # rank-R block Krylov (one shared block space per factor)
    op, B, _ = config4_block.block_problem(
        block["d"], block["n"], block["kappa"], block["rank"], 1234)
    cfg = tk.SolverConfig(kmax=block["kmax"], tol=TOL, check_every=8,
                          orth="lanczos_reorth", spectral_source="H")
    t0 = time.perf_counter()
    rb = tk.solve_block(op, B, cfg)
    jax.block_until_ready(rb.x.factors)
    Gb = np.einsum("rsn,qsn->srq", np.asarray(B), np.asarray(B))
    b_norm = float(np.sqrt(np.prod(Gb, axis=0).sum()))
    chk = cp_residual_cross_check_device(
        op, np.asarray(rb.x.weights, np.float64), rb.x.factors, B)
    out["block"] = dict(
        shape=block, status=int(rb.status), iterations=int(rb.niterations),
        estimate=_estimate(rb), measured_cp_residual=chk.value / b_norm,
        cp_residual_floor=chk.floor / b_norm, tol=TOL,
        wall_s=time.perf_counter() - t0)
    check(int(rb.status) == Status.CONVERGED,
          f"block: status {int(rb.status)}")
    check(chk.value / b_norm <= max(TOL, chk.floor / b_norm),
          "block: cross-check above max(tol, floor)")

    # certifying noise-recording deflated Lanczos (f32-pair basis)
    op, b, _ = flagship_problem(df64["d"], df64["n"], df64["kappa"], 1234)
    basis = flagship_basis(op, df64["m"])
    t0 = time.perf_counter()
    rd = tk.solve_deflated(
        op, b, tk.SolverConfig(kmax=df64["kmax"], tol=TOL,
                               orth="lanczos_reorth_auto"),
        basis=basis, storage="df64", final="device")
    out["df64"] = dict(
        shape=df64, status=rd.status, iterations=rd.niterations,
        certified_bound=rd.certified_bound[-1] if rd.certified_bound
        else None, measured_cp_residual=rd.measured_cp_residual,
        cp_residual_floor=rd.cp_residual_floor, tol=TOL,
        eft_eps_measured=rd.eft_eps_measured,
        wall_s=time.perf_counter() - t0)
    _check_certificate("df64", out["df64"])

    # recording block solver (rank-R, certified bound)
    br = block_recorded
    op, B, sigma = config4_block.block_problem(
        br["d"], br["n"], br["kappa"], br["rank"], 1234)
    n_ = br["n"]
    lmin_1d = 4.0 * (n_ + 1) ** 2 * np.sin(np.pi / (2 * (n_ + 1))) ** 2
    t0 = time.perf_counter()
    rr = tk.solve_block_recorded(
        op, B, tk.SolverConfig(kmax=br["kmax"], tol=TOL),
        lam_min=br["d"] * (sigma + lmin_1d), final="device")
    out["block_recorded"] = dict(
        shape=br, status=rr.status, iterations=rr.niterations,
        certified_bound=rr.certified_bound[-1] if rr.certified_bound
        else None, measured_cp_residual=rr.measured_cp_residual,
        cp_residual_floor=rr.cp_residual_floor, tol=TOL,
        wall_s=time.perf_counter() - t0)
    _check_certificate("block_recorded", out["block_recorded"])
    return out


# ---------------------------------------------------------------- phase 5


def phase_four(mesh, real_width: dict, flagship: dict) -> dict:
    """solve_sharded (gspmd and ring) at phase 3's shape and the deflated
    flagship on the mesh, each against its one-card run on device 0."""
    import jax

    import tensorkrylov as tk
    from tensorkrylov.parallel import solve_sharded

    op, b = real_width_problem(real_width["d"], real_width["n"],
                               real_width["kappa"])
    cfg = real_width_config(real_width["kmax"])
    out = {}
    dev0 = mesh.devices.flat[0]
    with jax.default_device(dev0):
        t0 = time.perf_counter()
        one = tk.solve(op, b, cfg)
        k1, s1 = int(one.niterations), int(one.status)
        out["one_card"] = dict(status=s1, iterations=k1,
                               estimate=_estimate(one),
                               wall_s=time.perf_counter() - t0)
    for comm in ("gspmd", "ring"):
        t0 = time.perf_counter()
        rs = solve_sharded(op, b, cfg, mesh, comm=comm)
        ks, ss, est = int(rs.niterations), int(rs.status), _estimate(rs)
        out[comm] = dict(status=ss, iterations=ks, estimate=est,
                         wall_s=time.perf_counter() - t0)
        check(ss == s1, f"{comm}: status {ss} vs one-card {s1}")
        check(abs(ks - k1) <= 1, f"{comm}: {ks} iterations vs one-card {k1}")
        check(est < TOL, f"{comm}: estimate {est} >= {TOL}")
    with jax.default_device(dev0):
        t0 = time.perf_counter()
        out["flagship_one_card"] = phase_flagship(**flagship)
        out["flagship_one_card"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["flagship_mesh"] = phase_flagship(**flagship, mesh=mesh)
    out["flagship_mesh"]["wall_s"] = time.perf_counter() - t0
    one_f, mesh_f = out["flagship_one_card"], out["flagship_mesh"]
    check(mesh_f["status"] == one_f["status"], "flagship mesh: status differs")
    check(abs(mesh_f["iterations"] - one_f["iterations"]) <= 1,
          "flagship mesh: iterations differ by more than 1")
    return out


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the 4-card mesh phase (needs 4 GPUs)")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    dev = require_gpu()
    print(gpu_name_and_power(), flush=True)
    from tensorkrylov.utils.cache import enable_compilation_cache

    print(f"jax {jax.__version__} devices={jax.devices()}", flush=True)
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS')}", flush=True)
    print(f"compile cache: {enable_compilation_cache()}", flush=True)
    clock = CompileClock()

    if args.four:
        from tensorkrylov.parallel import make_mesh

        check(len(jax.devices()) >= 4,
              f"--four needs 4 GPUs, found {len(jax.devices())}")
        mesh = make_mesh(4, factor_parallel=2)
        run_phase("phase5_four_cards", phase_four, clock, mesh=mesh,
                  real_width=REAL_WIDTH, flagship=FLAGSHIP)
        count = 4
    else:
        run_phase("phase1_small", phase_small, clock)
        run_phase("phase2_flagship", phase_flagship, clock, **FLAGSHIP)
        run_phase("phase3_real_width", phase_real_width, clock,
                  spmv_shape=SPMV_SHAPE, step_shape=STEP_SHAPE, **REAL_WIDTH)
        run_phase("phase4_paths", phase_paths, clock, nonsym=NONSYM,
                  block=BLOCK, df64=DF64, block_recorded=BLOCK_RECORDED)
        count = 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
