"""The port's params.py and data.py against the JAX package: the same
arguments give identical synthetic data; encodings, STA, theta init and the
box constraints match at float64 (rtol 1e-12)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_processes_tpu import data as jd
from gaussian_processes_tpu import params as jp
from gaussian_processes_tpu_torch import data as td
from gaussian_processes_tpu_torch import params as tp

torch.set_num_threads(1)

SMALL = dict(n_px_side=16, n_train=40, n_val=10, n_test=5, n_repeats=4)


def close(t, j, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=1e-14)


@pytest.mark.parametrize("gen", ["synthetic_retina", "synthetic_retina_hard"])
def test_synthetic_data_identical(gen, monkeypatch):
    monkeypatch.setenv("GPTPU_DATA_CACHE", "")
    kw = dict(SMALL, n_cells=2, seed=3)
    a = getattr(td, gen)(**kw)
    b = getattr(jd, gen)(**kw)
    for name in ("images_train", "responses_train", "images_val",
                 "responses_val", "images_test", "responses_test"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_array_equal(a.full_train()[0], b.full_train()[0])


def test_hard_data_cache_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("GPTPU_DATA_CACHE", str(tmp_path))
    a = td.synthetic_retina_hard(**SMALL, seed=1)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 1 and files[0].startswith("retina_hard_torch_")
    assert files[0].endswith(".pkl")             # no temporary left behind
    b = td.synthetic_retina_hard(**SMALL, seed=1)
    np.testing.assert_array_equal(a.images_train, b.images_train)


def test_encodings_match():
    v = np.array([-1.3, 0.2, 2.5])
    close(tp.logbetaexpr_to_beta(torch.as_tensor(v)),
          jp.logbetaexpr_to_beta(jnp.asarray(v)))
    close(tp.beta_to_logbetaexpr(torch.as_tensor(np.abs(v))),
          jp.beta_to_logbetaexpr(jnp.asarray(np.abs(v))))
    close(tp.logrhoexpr_to_rho(torch.as_tensor(v)),
          jp.logrhoexpr_to_rho(jnp.asarray(v)))
    close(tp.rho_to_logrhoexpr(torch.as_tensor(np.abs(v))),
          jp.rho_to_logrhoexpr(jnp.asarray(np.abs(v))))
    assert tp.fromlogbetasam_to_logbetaexpr(1.5) == \
        jp.fromlogbetasam_to_logbetaexpr(1.5)
    assert tp.fromlogrhosam_to_logrhoexpr(1.5) == \
        jp.fromlogrhosam_to_logrhoexpr(1.5)


def test_sta_theta_init_and_bounds_match():
    ds = td.synthetic_retina(**SMALL, n_cells=1, seed=0)
    X, R = ds.full_train()
    X, r = X.astype(np.float64), R[:, 0].astype(np.float64)
    t_sta, _, (ti, tj) = tp.get_sta(torch.as_tensor(X), torch.as_tensor(r), 16)
    j_sta, _, (ji, jj) = jp.get_sta(jnp.asarray(X), jnp.asarray(r), 16)
    close(t_sta, j_sta)
    assert (int(ti), int(tj)) == (int(ji), int(jj))
    tth, tlo, thi = tp.generate_theta(torch.as_tensor(X), torch.as_tensor(r),
                                      16, eps_0x=0.25)
    jth, jlo, jhi = jp.generate_theta(jnp.asarray(X), jnp.asarray(r), 16,
                                      eps_0x=0.25)
    assert (tlo, thi) == (jlo, jhi)
    for k in jp.THETA_KEYS:
        close(tth[k], jth[k])
        assert tth[k].dtype == torch.float64
    for k, v in tp.default_f_params(torch.float64).items():
        close(v, jp.default_f_params(jnp.float64)[k])
    out = dict(tth, eps_0x=torch.tensor(1.5, dtype=torch.float64),
               sigma_0=torch.tensor(-0.5, dtype=torch.float64))
    jout = {k: jnp.asarray(v.numpy()) for k, v in out.items()}
    assert bool(tp.theta_in_bounds(out)) == bool(jp.theta_in_bounds(jout))
    assert bool(tp.theta_in_bounds(tth)) and not bool(tp.theta_in_bounds(out))
    for k, v in tp.clip_theta(out).items():
        close(v, jp.clip_theta(jout)[k])


def test_generate_xtilde_takes_rows_and_jitters():
    x = torch.randn(30, 16, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    idx = torch.tensor([4, 0, 17])
    xt = tp.generate_xtilde(3, x, generator=torch.Generator().manual_seed(1),
                            idx=idx)
    assert xt.shape == (3, 16)
    assert 0 < float((xt - x[idx]).abs().max()) < 1e-12
    drawn = tp.generate_xtilde(5, x, generator=torch.Generator().manual_seed(2))
    again = tp.generate_xtilde(5, x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(drawn, again)
