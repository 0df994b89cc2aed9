"""The JAX package's model-comparison closures, rebuilt from its functions
(not a test module).

`scripts/run_model_comparison.py` defines its LMC, whitened SNMGP and
whitened SVC log-prior and log-likelihood closures inside `main()`; they
are written out here as that script has them (:84-230), one particle at a
time, so that the port's `drivers.model_comparison` can be held against
them.  Run as a script, it runs the JAX package's SMC on all three models
at the script's defaults (N = 48, 512 particles, 5 mutations, 16
leapfrogs) over three key sets, on the CPU, and prints each model's log Z:

    PYTHONPATH=. python tests/jax_model_comparison.py [--keys 0 100 200]

Key set 0 is the script's own (PRNGKey(1) ... PRNGKey(6)); key set s uses
PRNGKey(s + 1) ... PRNGKey(s + 6).
"""

import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from collaborative_nonstationary_multivariate_gaussian_process_tpu.models import (  # noqa: E402
    logdensities as ld,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops.distributions import (  # noqa: E402
    inverse_gamma_logpdf,
    mvn_logpdf_dense,
    mvn_logpdf_kron,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops.kernels import (  # noqa: E402
    nonstationary_rbf,
)
from collaborative_nonstationary_multivariate_gaussian_process_tpu.ops.linalg import (  # noqa: E402
    uvec_to_lvec,
    vec_to_tril,
)

HYP = dict(mu_tilde_l=-3.0, alpha_tilde_l=3.0, beta_tilde_l=0.4, mu_tilde_sigma=0.0,
           alpha_tilde_sigma=1.0, beta_tilde_sigma=1.0)
C = 10.0


def jax_models(x, Y):
    """{name: (log_prior, log_like, prior_sampler, chols)} of the script,
    on x (N,) and Y (N, M) JAX arrays; `chols` the whitening factors."""
    N, M = Y.shape
    T = ld.tri_size(M)
    y = Y.T.reshape(-1)

    def lmc_log_prior(q):
        lp = -0.5 * q[0] ** 2 - 0.5 * jnp.log(2 * jnp.pi)
        lp += -0.5 * q[1] ** 2 - 0.5 * jnp.log(2 * jnp.pi)
        lp += jnp.sum(-0.5 * (q[2:2 + T] / C) ** 2 - jnp.log(C) - 0.5 * jnp.log(2 * jnp.pi))
        s2e = jnp.exp(q[-1])
        lp += inverse_gamma_logpdf(s2e, 1.0, 1.0) + q[-1]
        return lp

    def lmc_log_like(q):
        p_ = ld.lmc_unflatten(q, M)
        L = vec_to_tril(uvec_to_lvec(p_.uL_vec, M), M)
        B_f = L @ L.T
        ell = jnp.exp(p_.tilde_l) * jnp.ones(N)
        sig = jnp.exp(p_.tilde_sigma) * jnp.ones(N)
        K_x = nonstationary_rbf(x, sigma1=sig, ell1=ell) + 1e-6 * jnp.eye(N)
        return mvn_logpdf_kron(y, jnp.zeros_like(y), B_f, K_x, jnp.exp(p_.tilde_sigma2_err))

    def lmc_prior_sampler(k, n):
        k1, k2, k3 = jax.random.split(k, 3)
        scal = jax.random.normal(k1, (n, 2))
        uL = C * jax.random.normal(k2, (n, T)) * 0.1
        g = jax.random.gamma(k3, 1.0, (n,))
        return jnp.concatenate([scal, uL, jnp.log(1.0 / g)[:, None]], axis=1)

    chol_l, chol_s = ld.snmgp_whiten_chols(x, HYP["alpha_tilde_l"], HYP["beta_tilde_l"],
                                           HYP["alpha_tilde_sigma"], HYP["beta_tilde_sigma"])

    def snmgp_log_prior(q):
        eta = q[:2 * N]
        uL = q[2 * N:2 * N + T]
        lp = jnp.sum(-0.5 * eta**2 - 0.5 * jnp.log(2 * jnp.pi))
        lp += jnp.sum(-0.5 * (uL / C) ** 2 - jnp.log(C) - 0.5 * jnp.log(2 * jnp.pi))
        s2e = jnp.exp(q[-1])
        lp += inverse_gamma_logpdf(s2e, 1.0, 1.0) + q[-1]
        return lp

    def snmgp_log_like(q):
        p_ = ld.snmgp_unwhiten(q, x, HYP["mu_tilde_l"], HYP["mu_tilde_sigma"], chol_l, chol_s, M)
        L = vec_to_tril(uvec_to_lvec(p_.uL_vec, M), M)
        B_f = L @ L.T
        K_x = nonstationary_rbf(x, sigma1=jnp.exp(p_.tilde_sigma),
                                ell1=jnp.exp(p_.tilde_l)) + 1e-6 * jnp.eye(N)
        return mvn_logpdf_kron(y, jnp.zeros_like(y), B_f, K_x, jnp.exp(p_.tilde_sigma2_err))

    def snmgp_prior_sampler(k, n):
        k1, k2, k3 = jax.random.split(k, 3)
        eta = jax.random.normal(k1, (n, 2 * N))
        uL = C * jax.random.normal(k2, (n, T)) * 0.1
        g = jax.random.gamma(k3, 1.0, (n,))
        return jnp.concatenate([eta, uL, jnp.log(1.0 / g)[:, None]], axis=1)

    chol_l_svc, chol_L_svc = ld.svc_whiten_chols(x, HYP["alpha_tilde_l"], HYP["beta_tilde_l"],
                                                 1.0, 1.0)
    dim_svc = N + N * T + 1
    eye_nm = jnp.eye(N * M, dtype=x.dtype)

    def svc_log_prior(q):
        eta = q[:-1]
        lp = jnp.sum(-0.5 * eta**2 - 0.5 * jnp.log(2 * jnp.pi))
        s2e = jnp.exp(q[-1])
        lp += inverse_gamma_logpdf(s2e, 1.0, 1.0) + q[-1]
        return lp

    def svc_log_like(q):
        p_ = ld.svc_unwhiten(q, x, HYP["mu_tilde_l"], 0.0, chol_l_svc, chol_L_svc, M)
        K, _ = ld.svc_covariance(p_.tilde_l, p_.uL_vecs, x)
        S = K + jnp.exp(p_.tilde_sigma2_err) * eye_nm
        return mvn_logpdf_dense(y, jnp.zeros_like(y), S)

    def svc_prior_sampler(k, n):
        k1, k2 = jax.random.split(k)
        eta = jax.random.normal(k1, (n, dim_svc - 1))
        g = jax.random.gamma(k2, 1.0, (n,))
        return jnp.concatenate([eta, jnp.log(1.0 / g)[:, None]], axis=1)

    return {
        "lmc": (lmc_log_prior, lmc_log_like, lmc_prior_sampler, None),
        "snmgp": (snmgp_log_prior, snmgp_log_like, snmgp_prior_sampler, (chol_l, chol_s)),
        "svc": (svc_log_prior, svc_log_like, svc_prior_sampler, (chol_l_svc, chol_L_svc)),
    }


def main():
    from collaborative_nonstationary_multivariate_gaussian_process_tpu.infer.smc import run_smc
    from collaborative_nonstationary_multivariate_gaussian_process_tpu.utils.sim import sim_mnts

    p = argparse.ArgumentParser()
    p.add_argument("--keys", type=int, nargs="+", default=[0, 100, 200])
    p.add_argument("--N", type=int, default=48)
    p.add_argument("--particles", type=int, default=512)
    p.add_argument("--mutations", type=int, default=5)
    args = p.parse_args()
    jax.config.update("jax_default_matmul_precision", "float32")
    x_np, _, _, _, Y_np = sim_mnts(M=2, N=args.N, seed=0)
    models = jax_models(jnp.asarray(x_np), jnp.asarray(Y_np))
    for s in args.keys:
        out = {}
        for i, name in enumerate(("lmc", "snmgp", "svc")):
            log_prior, log_like, sampler, _ = models[name]
            t0 = time.time()
            init = sampler(jax.random.PRNGKey(s + 2 * i + 1), args.particles)
            _, info = jax.jit(lambda q0, k, lp=log_prior, ll=log_like: run_smc(
                lp, ll, q0, k, num_mutations=args.mutations, num_leapfrog=16))(
                init, jax.random.PRNGKey(s + 2 * i + 2))
            out[name] = dict(log_z=float(info["log_z"]), stages=int(info["num_stages"]),
                             wall_s=time.time() - t0)
        print(json.dumps({"keys": s, **out}), flush=True)


if __name__ == "__main__":
    main()
