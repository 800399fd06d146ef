"""Offline packer for the Braess–Hackbusch exponential-sum tables.

The reference ships ~2 771 text files of optimal coefficients for
approximating 1/x on [1, R] plus an error-index CSV, and re-reads them from
disk *every solver iteration* (/root/reference/src/approximation.jl:119-147,
160-167). This packer parses everything once into a single npz so that
in-solver selection is a pure array gather (see tables.py):

  R_values (nR,)              — available condition numbers, ascending
  err      (nR, tmax)         — best uniform error of the rank-(j+1) sum on
                                [1, R]; inf where no table/file exists
  omega    (nR, tmax, tmax)   — ω coefficients, omega[r, j, :j+1] valid
  alpha    (nR, tmax, tmax)   — α coefficients
  grid     (10, n_orders)     — (first_digit, order) → row index, with the
                                reference's increment-digit-until-exists
                                fallback baked in
                                (/root/reference/src/approximation.jl:65-84);
                                falls through to the next decade if a whole
                                digit range is absent (the reference would
                                loop forever there)

File-format notes (SURVEY.md §2.11): each `1_xk{t:02d}.{digit}_{order}` file
has t lines of ω then t lines of α, one float (40 digits) per line with a
`{omega[i]}`/`{alpha[i]}` trailing label.

Run: python -m tensorkrylov.coeffs.preprocess [src_dir] [out.npz]
"""
from __future__ import annotations

import math
import os
import sys

import numpy as np

TMAX = 63
DEFAULT_SRC = "/root/reference/coefficients_data"
DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "data", "bh_tables.npz")


def parse_coefficient_file(path: str, t: int):
    """Parse one `1_xk` file → (omega (t,), alpha (t,)) float64."""
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            vals.append(float(line.split("{")[0].strip()))
    if len(vals) != 2 * t:
        raise ValueError(f"{path}: expected {2*t} values, got {len(vals)}")
    return np.array(vals[:t]), np.array(vals[t:])


def digit_order_of(R: float):
    order = int(math.floor(math.log10(R)))
    digit = int(math.floor(R / 10.0**order))
    return digit, order


def pack(src_dir: str = DEFAULT_SRC, out_path: str = DEFAULT_OUT) -> dict:
    csv_path = os.path.join(src_dir, "output_data", "tabelle_complete.csv")
    raw = []
    with open(csv_path) as f:
        header = f.readline()
        for line in f:
            parts = line.strip().split(",")
            if not parts or not parts[0]:
                continue
            raw.append([float(x) if x.lower() != "inf" else np.inf for x in parts])
    raw.sort(key=lambda r: r[0])
    nR = len(raw)
    R_values = np.array([r[0] for r in raw])
    err = np.full((nR, TMAX), np.inf)
    for i, r in enumerate(raw):
        vals = r[1 : 1 + TMAX]
        err[i, : len(vals)] = vals

    omega = np.zeros((nR, TMAX, TMAX))
    alpha = np.zeros((nR, TMAX, TMAX))
    n_files = 0
    for i in range(nR):
        digit, order = digit_order_of(R_values[i])
        for j in range(TMAX):
            if not np.isfinite(err[i, j]):
                continue
            t = j + 1
            fname = os.path.join(src_dir, f"1_xk{t:02d}.{digit}_{order}")
            if not os.path.exists(fname):
                # error tabulated but coefficients absent → never selectable
                err[i, j] = np.inf
                continue
            om, al = parse_coefficient_file(fname, t)
            omega[i, j, :t] = om
            alpha[i, j, :t] = al
            n_files += 1

    # (digit, order) → row grid with reference fallback semantics
    max_order = int(math.floor(math.log10(R_values[-1])))
    n_orders = max_order + 1
    exact = {}
    for i in range(nR):
        exact[digit_order_of(R_values[i])] = i
    grid = np.zeros((10, n_orders), np.int32)
    for order in range(n_orders):
        for digit in range(10):
            dd, oo = max(digit, 1), order
            row = None
            while row is None:
                row = exact.get((dd, oo))
                if row is None:
                    dd += 1
                    if dd > 9:  # reference would loop forever; go up a decade
                        dd, oo = 1, oo + 1
                    if oo > max_order:
                        row = nR - 1
            grid[digit, order] = row

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez_compressed(
        out_path,
        R_values=R_values,
        err=err,
        omega=omega,
        alpha=alpha,
        grid=grid,
    )
    return {
        "nR": nR,
        "n_files": n_files,
        "n_orders": n_orders,
        "out": out_path,
        "bytes": os.path.getsize(out_path),
    }


if __name__ == "__main__":
    src = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_SRC
    out = sys.argv[2] if len(sys.argv) > 2 else DEFAULT_OUT
    info = pack(src, out)
    print(info)
