"""MIMO beamforming (`problems/beamforming.py`, native complex64) against
the JAX package's (re, im) pairs: `torch.einsum` against JAX's `cmatmul`
within 1e-5, `torch.linalg.inv` against JAX's Newton-Schulz `hpd_inverse`
within 1e-3 (JAX's own test's tolerance), sum rate, ZF and MMSE within 1e-4, `PrecoderPolicy` with
JAX's params converted within 1e-5, the relay within 1e-4, and five
`train_beamforming` steps from JAX's params with its channels injected:
the history within 1e-3. The channel and relay builders draw on the card
unless told "cpu"."""

import jax
import numpy as np
import pytest
import torch

from rlsolver_tpu.problems import beamforming as jb
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.problems import beamforming as tb

torch.set_num_threads(1)
SPEC_KW = dict(num_users=4, num_antennas=4, total_power=10.0)
JSPEC, TSPEC = jb.BeamformingSpec(**SPEC_KW), tb.BeamformingSpec(**SPEC_KW)


def rand_complex(rng, shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)).astype(np.complex64)


def jchan(seed, spec, batch):
    """JAX's channels and the same as complex64."""
    h = jb.random_channels(jax.random.PRNGKey(seed), spec, batch)
    return h, tb.from_numpy(h.to_numpy())


def test_cmatmul_and_inverse():
    rng = np.random.default_rng(0)
    a, b = rand_complex(rng, (3, 4, 5)), rand_complex(rng, (3, 5, 6))
    out = torch.einsum("bij,bjk->bik", tb.from_numpy(a), tb.from_numpy(b))
    ref = jb.cmatmul(jb.CTensor.from_numpy(a), jb.CTensor.from_numpy(b), "bij,bjk->bik").to_numpy()
    np.testing.assert_allclose(tb.to_numpy(out), ref, rtol=0, atol=1e-5)
    h = rand_complex(rng, (5, 4, 4))
    hpd = h @ h.conj().transpose(0, 2, 1) + 0.5 * np.eye(4)
    inv = tb.to_numpy(torch.linalg.inv(tb.from_numpy(hpd)))
    np.testing.assert_allclose(inv, jb.hpd_inverse(jb.CTensor.from_numpy(hpd)).to_numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(inv, np.linalg.inv(hpd), rtol=0, atol=1e-4)


def test_sum_rate_zf_mmse_match_jax():
    jh, th = jchan(3, JSPEC, 16)
    rng = np.random.default_rng(2)
    w = rand_complex(rng, (16, 4, 4))
    np.testing.assert_allclose(tb.sum_rate(th, tb.from_numpy(w)).numpy(),
                               np.asarray(jb.sum_rate(jh, jb.CTensor.from_numpy(w))), rtol=0, atol=1e-4)
    # JAX's Newton-Schulz inverse has not converged on an ill-conditioned
    # Gram matrix (here ZF's of batch element 13, condition 1686: residual
    # 1.7e-2, 2.4e-3 off the exact ZF): the port is held to a float64 numpy
    # ZF/MMSE on every element, and to JAX's where its residual is below 1e-5
    hn = jh.to_numpy().astype(np.complex128)
    hh = hn @ hn.conj().transpose(0, 2, 1) + 1e-4 * np.eye(4)
    gram = hn.conj().transpose(0, 2, 1) @ hn + 0.4 * np.eye(4)
    exact = {"zf": hn.conj().transpose(0, 2, 1) @ np.linalg.inv(hh),
             "mmse": np.linalg.inv(gram) @ hn.conj().transpose(0, 2, 1)}
    for name, a, jf, tf in (("zf", hh, jb.zf_beamformer, tb.zf_beamformer),
                            ("mmse", gram, jb.mmse_beamformer, tb.mmse_beamformer)):
        jw, tw = jf(jh, JSPEC), tf(th, TSPEC)
        ref = exact[name] * np.sqrt(10.0 / (np.abs(exact[name]) ** 2).sum(axis=(1, 2), keepdims=True))
        np.testing.assert_allclose(tb.to_numpy(tw), ref, rtol=0, atol=1e-4, err_msg=name)
        inv = jb.hpd_inverse(jb.CTensor.from_numpy(a.astype(np.complex64))).to_numpy()
        converged = np.abs(np.eye(4) - a @ inv).max(axis=(1, 2)) < 1e-5
        assert converged.sum() >= 14, name
        np.testing.assert_allclose(tb.to_numpy(tw)[converged], jw.to_numpy()[converged], rtol=0, atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(tb.sum_rate(th, tw).numpy()[converged],
                                   np.asarray(jb.sum_rate(jh, jw))[converged], rtol=0, atol=1e-4, err_msg=name)
    # ZF nulls interference; MMSE at least ZF at low SNR; power normalised
    hw = tb.to_numpy(torch.einsum("bkn,bnj->bkj", th, tb.zf_beamformer(th, TSPEC)))
    assert np.abs(hw - np.einsum("bii->bi", hw)[:, :, None] * np.eye(4)).max() < 5e-2
    low = tb.BeamformingSpec(num_users=4, num_antennas=4, total_power=1.0)
    assert float(tb.sum_rate(th, tb.mmse_beamformer(th, low)).mean()) >= float(
        tb.sum_rate(th, tb.zf_beamformer(th, low)).mean()) - 1e-3
    p = tb.mmse_beamformer(th, TSPEC).abs().square().sum(dim=(1, 2))
    np.testing.assert_allclose(p.numpy(), 10.0, rtol=1e-5)


def test_precoder_policy_with_converted_params():
    jh, th = jchan(4, JSPEC, 8)
    jw = jb.mmse_beamformer(jh, JSPEC)
    policy = jb.PrecoderPolicy(JSPEC)
    params = policy.init(jax.random.PRNGKey(1), jh, jw)
    tp = tb.PrecoderPolicy(TSPEC)
    tp.load_state_dict(convert.precoder_state_dict(jax.tree.map(np.asarray, params)))
    out = tp(th, tb.from_numpy(jw.to_numpy()))
    np.testing.assert_allclose(tb.to_numpy(out), policy.apply(params, jh, jw).to_numpy(), rtol=0, atol=1e-5)


def test_relay_matches_jax():
    jspec, tspec = jb.RelaySpec(), tb.RelaySpec()
    kg, kh = jax.random.split(jax.random.PRNGKey(6))
    jg, jh = jb.random_relay_channels(jax.random.PRNGKey(6), jspec, 16)
    normal = [np.array(jax.random.normal(k, s)) for k, s in (
        (kg, (16, 2, 2)), (jax.random.fold_in(kg, 1), (16, 2, 2)), (kh, (16, 2, 2)), (jax.random.fold_in(kh, 1), (16, 2, 2)))]
    tg, th = tb.random_relay_channels(None, tspec, 16, normal=[torch.from_numpy(x) for x in normal])
    np.testing.assert_allclose(tb.to_numpy(tg), jg.to_numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.to_numpy(th), jh.to_numpy(), rtol=0, atol=1e-6)
    jf, tf = jb.identity_relay(jspec, 16), tb.identity_relay(tspec, 16, device="cpu")
    np.testing.assert_allclose(tb.to_numpy(tf), jf.to_numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.to_numpy(tb.relay_effective_channel(th, tf, tg)),
                               jb.relay_effective_channel(jh, jf, jg).to_numpy(), rtol=0, atol=1e-4)
    rates = tb.relay_sum_rate(th, tf, tg, tspec).numpy()
    np.testing.assert_allclose(rates, np.asarray(jb.relay_sum_rate(jh, jf, jg, jspec)), rtol=0, atol=1e-4)
    assert np.isfinite(rates).all() and (rates > 0).all()


def test_five_training_steps_match_jax():
    spec_kw = dict(num_users=2, num_antennas=2)
    jspec, tspec = jb.BeamformingSpec(**spec_kw), tb.BeamformingSpec(**spec_kw)
    cfg_kw = dict(batch=32, episode_length=3, num_steps=5, lr=1e-3, seed=2)
    jcfg, tcfg = jb.BeamformingTrainConfig(**cfg_kw), tb.BeamformingTrainConfig(**cfg_kw)
    jpolicy, jparams, jhist = jb.train_beamforming(jspec, jcfg)
    np.testing.assert_array_equal(tb.curriculum_basis(tspec, 2), np.asarray(
        np.linalg.qr(np.random.RandomState(2).rand(8, 8))[0], np.float32))
    # the initial params and each step's draws, split from the key as
    # `train_beamforming` splits it
    key = jax.random.PRNGKey(jcfg.seed)
    k_init, key = jax.random.split(key)
    h0 = jb.random_channels(k_init, jspec, 1)
    params = jpolicy.init(k_init, h0, jb.mmse_beamformer(h0, jspec))
    draws = []
    for _ in range(jcfg.num_steps):
        key, k_h = jax.random.split(key)
        kr, ki = jax.random.split(k_h)
        shape = (jcfg.batch, 2, 2)
        draws.append(tb.StepDraws(*(torch.from_numpy(np.array(x)) for x in (
            jax.random.normal(kr, shape), jax.random.normal(ki, shape), jax.random.normal(k_h, (jcfg.batch, 8))))))
    tp = tb.PrecoderPolicy(tspec)
    tp.load_state_dict(convert.precoder_state_dict(jax.tree.map(np.asarray, params)))
    policy, hist = tb.train_beamforming(tspec, tcfg, device="cpu", policy=tp, draws=draws)
    np.testing.assert_allclose(hist, jhist, rtol=0, atol=1e-3)
    ref = convert.precoder_state_dict(jax.tree.map(np.asarray, jparams))
    for k, v in policy.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=1e-4, err_msg=k)


def test_training_from_the_generator_improves():
    cfg = tb.BeamformingTrainConfig(batch=64, episode_length=3, num_steps=40, lr=1e-3)
    policy, hist = tb.train_beamforming(TSPEC, cfg, device="cpu")
    assert np.isfinite(hist).all() and np.mean(hist[-10:]) > np.mean(hist[:10]) - 0.2


# public builders that put tensors on a device: `cuda` unless told "cpu"
ENTRY_POINTS = {
    "random_channels": lambda dev: tb.random_channels(torch.Generator(), TSPEC, 2, device=dev),
    "random_relay_channels": lambda dev: tb.random_relay_channels(torch.Generator(), tb.RelaySpec(), 2, device=dev)[0],
    "identity_relay": lambda dev: tb.identity_relay(tb.RelaySpec(), 2, device=dev),
    "train_beamforming": lambda dev: tb.train_beamforming(
        TSPEC, tb.BeamformingTrainConfig(batch=4, episode_length=1, num_steps=1), device=dev)[0].Dense_0.kernel,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert ENTRY_POINTS[name]("cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](None)
