"""Bodies of the ranks that the multi-rank port tests spawn (not a test
module).  Each runs in a fresh process of a gloo group on the CPU
(`parallel.launch.spawn`), reads its inputs from an .npz the test wrote,
and returns a JSON-able dict; none imports JAX: the tests compute the JAX
side, and the JAX draws a rank replays, before they spawn."""

import numpy as np
import torch
import torch.distributed as dist

from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer import dsvi as td
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.chees import (
    run_chees,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.hmc import (
    GeneratorDraws,
    run_hmc,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.infer.nuts import run_nuts
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.models import cnmgp as tc
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel import mesh as pm
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.sharded_mcmc import (  # noqa: E501
    fold_in,
    run_chees_sharded,
    run_hmc_sharded,
    run_nuts_sharded,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.parallel.sharded_smc import (  # noqa: E501
    run_smc_sharded,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu_torch.utils import (
    checkpoint as tckpt,
)

torch.set_num_threads(1)


def _lists(tensors):
    return [t.detach().double().reshape(-1).tolist() for t in tensors]


class ReplayEpochDraws:
    """The JAX `run(..., key, n_epochs)` draws as the test saved them:
    each epoch's sort keys, then each step's noise (S = 1)."""

    def __init__(self, f):
        self.keys = [torch.as_tensor(k) for k in f["sort_keys"]]
        self.noises = [tc.CNMGPNoise(*(torch.as_tensor(f[k][i]) for k in
                                       ("z_v1", "z_v2", "z_te", "z_diag", "z_off")), None, None)
                       for i in range(f["z_v1"].shape[0])]

    def sort_keys(self, n):
        return self.keys.pop(0)

    def noise(self):
        return self.noises.pop(0)


def dsvi_rank(path: str) -> dict:
    """The data-parallel DSVI checks of tests/test_torch_parallel.py on a
    2 x 1 mesh: the mesh's shapes and the host-local loading roundtrip,
    `inference(mesh=...)`, and `make_scan_epochs(mesh=...)` on the JAX
    draws from the JAX parameters (carried, then broadcast from rank 0)."""
    f = dict(np.load(path))
    rank = dist.get_rank()
    assert pm.initialize_distributed() == (rank, 2)
    mesh = pm.make_mesh(data=2)
    out = {"shape": mesh.shape, "chain_shape": pm.make_mesh(chain=2).shape,
           "pod_shape": pm.make_pod_mesh().shape, "coordinate": mesh.coordinate("data")}
    full = torch.arange(8 * 3, dtype=torch.float64).reshape(8, 3)
    start, size = pm.process_local_slice(mesh, 8)
    out["slice"] = [start, size]
    g = pm.global_batch_from_local(mesh, {"x": full[start:start + size]})["x"]
    out["roundtrip"] = bool(torch.equal(g, full))
    out["shard"] = pm.shard_batch(mesh, full)[:, 0].tolist()

    lists = [f["x0"], f["x1"]], [f["y0"], f["y1"]]
    kw = dict(batch_size=16, dim_outputs=2, itnum=6, lr=0.01, seed=11, show_ELBO=False,
              dtype=torch.float64, device="cpu")
    res = td.inference(*lists, f["z"], mesh=mesh, **kw)
    out["inference_losses"] = res.loss_list
    out["inference_params"] = _lists(res.params)

    # the JAX parameters, carried on rank 0 and broadcast
    fields = {name: f[f"p_{name}"] if rank == 0 else np.zeros_like(f[f"p_{name}"])
              for name in tc.CNMGPParams._fields}
    p0 = tc.params_from_numpy(fields, device="cpu", dtype=torch.float64)
    pt = tc.CNMGPParams(*(mesh.broadcast_(t.clone(), 0).requires_grad_(True) for t in p0))
    out["carried_params"] = _lists(pt)
    opt = td.make_optimizer(pt, "adam", 0.01)
    nb = -(-len(f["x"]) // 16)
    run = td.make_scan_epochs(opt, float(len(f["x"])), 1e-4, nb, 16, mesh=mesh)
    T = torch.as_tensor
    losses = run(pt, td.freeze_mask(pt, True), T(f["z"]), T(f["x"]), T(f["y"]), T(f["idx"]),
                 ReplayEpochDraws(f), int(f["epochs"]))
    out["scan_losses"] = losses.tolist()
    out["scan_params"] = _lists(pt)
    return out


def _gauss_lp(q):
    scale = torch.arange(1, q.shape[-1] + 1, dtype=q.dtype)
    return -0.5 * torch.sum((q / scale) ** 2, dim=-1)


class ReplayCheesDraws:
    """A ChEES iteration's (C, dim) normals and (C,) uniforms, in order."""

    def __init__(self, z, u):
        self._z, self._u, self._i = torch.as_tensor(z), torch.as_tensor(u), -1

    def momentum(self):
        self._i += 1
        return self._z[self._i]

    def accept(self):
        return self._u[self._i]


def mcmc_rank(path: str) -> dict:
    """The chain-sharded samplers of tests/test_torch_sharded_mcmc.py on a
    1 x 2 mesh: each rank's block of NUTS and HMC against the unsharded
    runs on its chains and draws, ChEES on the JAX draws of this shard, and
    ChEES at two dispatch lengths."""
    f = dict(np.load(path))
    mesh = pm.make_mesh(data=1, chain=2)
    r = mesh.coordinate("chain")
    q0 = torch.as_tensor(f["q0"])
    c = q0.shape[0] // 2
    block = q0[r * c:(r + 1) * c]
    out = {}

    def own_draws():
        gen = torch.Generator().manual_seed(fold_in(5, r))
        return GeneratorDraws(gen, c, q0.shape[1], q0.dtype, q0.device)

    kw = dict(num_warmup=12, num_samples=6)
    pos, info = run_nuts_sharded(_gauss_lp, q0, 5, mesh, max_depth=4, **kw)
    want, winfo = run_nuts(_gauss_lp, block, max_depth=4, draws=own_draws(), **kw)
    out["nuts_block_equal"] = bool(torch.equal(pos[r * c:(r + 1) * c], want)) and all(
        torch.equal(info[k][r * c:(r + 1) * c], winfo[k])
        for k in ("accept_prob", "log_prob", "num_steps", "diverging", "step_size"))
    out["nuts_positions"] = pos.reshape(-1).tolist()
    out["nuts_host_reads"] = info["host_reads"]

    pos, info = run_hmc_sharded(_gauss_lp, q0, 5, mesh, num_steps=5, **kw)
    want, winfo = run_hmc(_gauss_lp, block, num_steps=5, draws=own_draws(), **kw)
    out["hmc_block_equal"] = bool(torch.equal(pos[r * c:(r + 1) * c], want)) and all(
        torch.equal(info[k][r * c:(r + 1) * c], winfo[k])
        for k in ("accept_prob", "log_prob", "step_size", "inv_mass"))
    out["hmc_positions"] = pos.reshape(-1).tolist()

    ckw = dict(num_warmup=int(f["chees_warmup"]), num_samples=int(f["chees_samples"]),
               init_traj_length=0.5)
    pos, info = run_chees_sharded(_gauss_lp, q0, 0, mesh,
                                  draws=ReplayCheesDraws(f[f"chees_z{r}"], f[f"chees_u{r}"]), **ckw)
    out["chees_positions"] = pos.reshape(-1).tolist()
    out["chees_accept_prob"] = info["accept_prob"].reshape(-1).tolist()
    out["chees_num_steps"] = info["num_steps"].tolist()
    for k in ("step_size", "trajectory_length", "warmup_accept_mean"):
        out[f"chees_{k}"] = float(info[k])
    out["chees_inv_mass"] = info["inv_mass"].tolist()

    a = run_chees_sharded(_gauss_lp, q0, 9, mesh, max_iters_per_dispatch=1024, **ckw)
    b = run_chees_sharded(_gauss_lp, q0, 9, mesh, max_iters_per_dispatch=13, **ckw)
    out["chees_chunk_invariant"] = bool(torch.equal(a[0], b[0])) and bool(
        torch.equal(a[1]["accept_prob"], b[1]["accept_prob"])) and float(
        a[1]["step_size"]) == float(b[1]["step_size"])
    # the unsharded ChEES of this rank's block is another run: the mean
    # over the block alone adapts another step size
    alone, _ = run_chees(_gauss_lp, block, draws=ReplayCheesDraws(f[f"chees_z{r}"],
                                                                 f[f"chees_u{r}"]), **ckw)
    out["chees_differs_from_a_block_alone"] = not torch.equal(alone, pos[r * c:(r + 1) * c])
    return out


class ReplaySMCDraws:
    """A shard's SMC draws as the test saved them: per stage the resampling
    uniform, per mutation the (P_local, dim) normals and (P_local,)
    uniforms."""

    def __init__(self, u0, z, u):
        self.u0, self.z, self.u = (torch.as_tensor(a) for a in (u0, z, u))
        self.stage, self.mut = -1, -1

    def resample(self):
        self.stage += 1
        self.mut = -1
        return self.u0[self.stage]

    def momentum(self):
        self.mut += 1
        return self.z[self.stage, self.mut]

    def accept(self):
        return self.u[self.stage, self.mut]


def smc_rank(path: str) -> dict:
    """The particle-sharded SMC of tests/test_torch_sharded_smc.py on a
    1 x 2 mesh: the conjugate model with the port's draws, and the small
    conjugate model on the JAX draws of this shard."""
    f = dict(np.load(path))
    mesh = pm.make_mesh(data=1, chain=2)
    r = mesh.coordinate("chain")
    d, tau2, sig2 = 3, 4.0, 1.0

    def log_prior(q):
        return -0.5 * torch.sum(q**2, -1) / tau2 - 0.5 * d * np.log(2 * np.pi * tau2)

    def log_like(q):
        return -0.5 * torch.sum((1.0 - q) ** 2, -1) / sig2 - 0.5 * d * np.log(2 * np.pi * sig2)

    pos, info = run_smc_sharded(log_prior, log_like, torch.as_tensor(f["init"]), 1, mesh,
                                num_mutations=4, num_leapfrog=8)
    out = {"log_z": float(info["log_z"]), "stages": int(info["num_stages"]),
           "mean": pos.mean(0).tolist(), "var": pos.var(0, correction=0).tolist(),
           "shape": list(pos.shape)}

    s0, s1, y = 2.0, 0.5, torch.as_tensor(f["y_obs"])

    def prior2(q):
        return (-0.5 * torch.sum(q**2, dim=-1) / s0**2 - 2 * np.log(s0) - np.log(2 * np.pi))

    def like2(q):
        return (-0.5 * torch.sum((y - q) ** 2, dim=-1) / s1**2 - 2 * np.log(s1)
                - np.log(2 * np.pi))

    draws = ReplaySMCDraws(f["res_u0"], f[f"z{r}"], f[f"u{r}"])
    pos, info = run_smc_sharded(prior2, like2, torch.as_tensor(f["q0"]), 0, mesh,
                                num_mutations=2, num_leapfrog=4, draws=draws)
    out.update(jax_positions=pos.reshape(-1).tolist(), jax_log_z=float(info["log_z"]),
               jax_stages=int(info["num_stages"]), jax_betas=info["betas"].tolist(),
               jax_step_size=float(info["final_step_size"]))
    return out


def checkpoint_rank(path: str, state: str) -> dict:
    """Save the state of `state` (an .npz of params and optimizer leaves)
    as a directory checkpoint at world 2, load it back at world 2, and
    report whether every leaf came back bit for bit."""
    f = dict(np.load(state))
    params = [torch.as_tensor(f[f"p{i}"]) for i in range(int(f["n_params"]))]
    opt = [torch.as_tensor(f[f"o{i}"]) for i in range(int(f["n_opt"]))]
    opt[-1] = opt[-1].to(torch.bfloat16)
    tckpt.save_train_state(path, params, opt, epoch=7, loss=1.25, backend="orbax")
    like_p = [torch.zeros_like(t) for t in params]
    like_o = [torch.zeros_like(t) for t in opt]
    lp, lo = tckpt.load_train_state(path, like_p, like_o, backend="orbax")
    same = all(torch.equal(a, b) for a, b in zip(lp + lo, params + opt))
    return {"same": bool(same), "dtypes": [str(t.dtype) for t in lo]}
