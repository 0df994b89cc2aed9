"""Inputs the benchmark makes from a seed and hands to both the port and the
reference: data, starting weights and draws.

The generators here and in `generators/` are the benchmark's own copies
(the reference study's simulators, the surrogate series and the port's draw
order), so a change to the port cannot move them.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

GENERATORS = Path(__file__).resolve().parent / "generators"


def seeds(seed: int, n: int):
    """n independent 63-bit seeds from one `--seed` (any whole number >= 0)."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n, np.uint64) >> 1]


def observations(cfg, dev, dtype=torch.float32, root=None):
    """The configuration's data, as its `data` entry states it: flat (x, y,
    idx) from the generator `portbench/generators/<generator>.py` (under
    `root`, if given) found by name, and Z = linspace(0, x_max, M).  One
    output a `lengths` entry."""
    spec = cfg["data"]
    if len(spec["lengths"]) != cfg["D"]:
        raise ValueError(f"data: {len(spec['lengths'])} output lengths for D = {cfg['D']}")
    base = GENERATORS if root is None else Path(root) / GENERATORS.parent.name / GENERATORS.name
    path = base / f"{spec['generator']}.py"
    if not path.exists():
        raise ValueError(f"data: no generator {path}")
    mod_spec = importlib.util.spec_from_file_location(f"portbench_generator_{path.stem}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    x, y, idx = mod.make(spec, dev, dtype)
    return x, y, idx, torch.linspace(0.0, float(spec["x_max"]), cfg["M"], dtype=dtype, device=dev)


def cnmgp_weights(cfg, seed: int, dev, dtype=torch.float32):
    """Starting variational parameters from `seed`, drawn on the device in
    one call (the reference study's initialization: 0.1-scaled Gaussian
    means and factors, mu_v a constant) and the log hyperparameters of the
    configuration.  A dict keyed by the parameter names."""
    D, M = cfg["D"], cfg["M"]
    G = D * (D + 1) // 2
    shapes = {"mu_W": (D, M), "sqrt_W": (D, M, M), "sqrt_v": (M, M), "mu_U": (G, M),
              "sqrt_U": (G, M, M)}
    sizes = [int(np.prod(s)) for s in shapes.values()]
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, dtype=dtype, device=dev)
    out = {}
    for (name, shape), part in zip(shapes.items(), torch.split(flat, sizes)):
        scale = cfg["init_scale_mean"] if name.startswith("mu") else cfg["init_scale_sqrt"]
        out[name] = scale * part.reshape(shape)
    out["mu_v"] = torch.full((M,), float(cfg["mu_v_init"]), dtype=dtype, device=dev)
    for name, value in cfg["log_hyperpars"].items():
        out[name] = torch.tensor(float(value), dtype=dtype, device=dev)
    return out


def sort_keys(gen: torch.Generator, n: int) -> torch.Tensor:
    """An epoch's shuffle keys as the port's trainer draws them: n int64 in [0, 2^32)."""
    return torch.randint(0, 2**32, (n,), generator=gen, dtype=torch.int64, device=gen.device)


def train_noise(gen: torch.Generator, M: int, B: int, D: int, dtype=torch.float32) -> dict:
    """One training step's standard normals in the port's draw order
    (z_v1, z_v2, z_te, z_diag, z_off), each with a leading draw dim of 1."""
    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)

    names = ("z_v1", "z_v2", "z_te", "z_diag", "z_off")
    shapes = ((1, M), (1, M), (1, B), (1, D, B), (1, D * (D - 1) // 2, B))
    return {n: normal(*s) for n, s in zip(names, shapes)}


def predictive_noise(seed: int, S: int, M: int, B: int, D: int, per_chunk: int, keep, dev,
                     dtype=torch.float32) -> dict:
    """The standard normals of draws `keep` (sorted indices) of S predictive
    draws at B points, in the port's draw order: a generator on `dev` seeded
    with `seed`, then chunk by chunk of `per_chunk` draws z_v1, z_v2 (s, M),
    z_te (s, B), z_diag (s, D, B), z_off (s, D(D-1)/2, B), z_g (s, D, B),
    z_y (s, B).  Only the kept draws are held."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    T0 = D * (D - 1) // 2
    names = ("z_v1", "z_v2", "z_te", "z_diag", "z_off", "z_g", "z_y")
    keep = np.asarray(keep)
    out = {n: [] for n in names}
    for start in range(0, S, per_chunk):
        s = min(per_chunk, S - start)
        shapes = ((s, M), (s, M), (s, B), (s, D, B), (s, T0, B), (s, D, B), (s, B))
        chunk = {n: torch.randn(sh, generator=gen, dtype=dtype, device=dev)
                 for n, sh in zip(names, shapes)}
        rows = keep[(keep >= start) & (keep < start + s)] - start
        for n in names:
            out[n].append(chunk[n][torch.as_tensor(rows, dtype=torch.int64, device=dev)])
    return {n: torch.cat(v) for n, v in out.items()}


def sim_mnts(N: int, seed: int, sigma2_err: float = 1e-2):
    """The reference study's two-output nonstationary series (SIM_code/sim.py:
    18-87): x (N,) sorted uniform, lengthscale process 3(x-1)^3 - 3, stds
    1+x^2 and 2-x^2, correlation cos(pi x), an exact draw of Y (N, 2)."""
    M = 2
    rng = np.random.default_rng(seed)
    x = np.sort(rng.random(N))
    ell = np.exp(3 * (x - 1) ** 3 - 3)
    stds = np.stack([1 + x**2, 2 - x**2], axis=1)
    cors = np.cos(x * np.pi)
    L_f = np.zeros((N, M, M))
    for n in range(N):
        B_f = np.diag(stds[n]) @ np.array([[1.0, cors[n]], [cors[n], 1.0]]) @ np.diag(stds[n])
        L_f[n] = np.linalg.cholesky(B_f)
    d2 = (x[:, None] - x[None, :]) ** 2
    den = ell[:, None] ** 2 + ell[None, :] ** 2
    K_x = np.sqrt(2.0 * ell[:, None] * ell[None, :] / den) * np.exp(-d2 / den)
    K = np.einsum("nm,nia,mja->injm", K_x, L_f, L_f).reshape(M * N, M * N)
    K += sigma2_err * np.eye(M * N)
    y = rng.multivariate_normal(np.zeros(M * N), K, method="cholesky")
    return x, y.reshape(M, N).T
