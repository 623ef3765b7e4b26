"""The port's AKAZE-class engine (``flow/akaze_tpu.py``) against the JAX
package, on the CPU, on the same numpy inputs made from a seed.

Tolerances, as measured at 120x160:

- ``_gauss1d``, ``_ldb_pairs`` and the descriptor grid: equal;
  ``_downsample2``: within 1e-6 (a 4-term mean in another order);
- the scale space from the same base and contrast factor: every level's
  image, gradients and det-Hessian within REL of the level's scale
  (measured <= 1.8e-6; explicit steps of the same stencils);
- the contrast factor (``torch.nanquantile`` against
  ``jnp.nanpercentile``, both linear): within 1e-6 relative;
- ``detect``: the valid keypoints (score > 0) as sets of rounded
  positions, >= 99% shared; shared ones within 1e-3 px, scores within
  1e-4 relative, angles within 1e-3 rad, sizes equal (measured: 7.6e-5
  px, 2.5e-5, 4.5e-5 rad); ``describe``: >= 99% of the shared
  keypoints' bits equal (measured: all);
- ``stabilize_pair`` with features 'akaze' on JAX's RANSAC samples: the
  inlier count within 2%, the homography's frame corners within 0.01 px
  (two chains of float32 steps), the corrected frame at most 1% of
  pixels apart, by one uint8 level (pixels whose sample crosses the
  frame's edge between the two H left out); measured: 182 inliers on
  both, 5.2e-5 px, 0.005% of pixels one level apart.
"""

import numpy as np
import torch

import cv2
import jax
import jax.numpy as jnp

from ripcurrents_tpu.flow import akaze_tpu as jak
from ripcurrents_tpu.flow import feature_stab as jfs
from ripcurrents_tpu_torch.flow import akaze_tpu as tak
from ripcurrents_tpu_torch.flow import feature_stab as tfs

torch.set_num_threads(1)

H, W = 120, 160
REL = 1e-5
T = torch.from_numpy
J = jnp.asarray


def blobs(seed, h=H, w=W):
    """Blurred noise with filled discs (what AKAZE finds), uint8."""
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.uniform(0, 255, (h, w)).astype(np.float32),
                           (0, 0), 1.2)
    for _ in range(60):
        cv2.circle(img, (int(rng.uniform(8, w - 8)),
                         int(rng.uniform(8, h - 8))),
                   int(rng.uniform(2, 6)), float(rng.uniform(0, 255)), -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def rel_close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, \
        np.abs(got - want).max() / scale


def test_scale_space_levels_match_jax():
    img = blobs(0)
    assert np.array_equal(tak._gauss1d(1.6), np.asarray(jak._gauss1d(1.6)))
    assert np.array_equal(tak._ldb_pairs(16, 256), jak._ldb_pairs(16, 256))
    assert np.array_equal(tak._GRID, jak._GRID)
    f = img.astype(np.float32) / 255.0
    rel_close(tak._downsample2(T(f)), jak._downsample2(J(f)), 1e-6)
    base = np.asarray(jak.sep_filter2d(J(f), jak._gauss1d(1.6),
                                       jak._gauss1d(1.6),
                                       border="replicate"))
    k2 = np.array(0.003, np.float32)
    jl = jak._build_levels(J(base), 2, 3, 1.6, 0.23, J(k2))
    tl = tak._build_levels(T(base), 2, 3, 1.6, 0.23, T(k2))
    assert len(jl) == len(tl) == 6
    for j, t in zip(jl, tl):
        assert (t.sigma, t.octave) == (j.sigma, j.octave)
        for name in ("img", "gx", "gy", "resp"):
            rel_close(getattr(t, name), getattr(j, name))
    # the contrast factor: the 70th percentile of the nonzero gradient
    gx, gy = tak._grad(T(base))
    mag = torch.sqrt(gx * gx + gy * gy)
    nz = torch.where(mag > 1e-6, mag, float("nan")).reshape(-1)
    want = float(jnp.nanpercentile(J(nz.numpy()), 70.0))
    assert abs(torch.nanquantile(nz, 0.7).item() - want) <= 1e-6 * want


def _keyed(kps):
    v = kps.score.numpy() > 0 if torch.is_tensor(kps.score) else \
        np.asarray(kps.score) > 0
    xy = np.asarray(kps.xy)[v]
    return {tuple(np.round(p).astype(int)): i
            for i, p in zip(np.flatnonzero(v), xy)}


def test_detect_and_describe_match_jax():
    img = blobs(1)
    jk, jd = jak.detect_and_describe(J(img))
    tk, td = tak.detect_and_describe(T(img))
    jm, tm = _keyed(jk), _keyed(tk)
    assert len(jm) > 100
    shared = set(jm) & set(tm)
    assert len(shared) >= 0.99 * len(jm) and len(tm) == len(jm)
    ji = np.array([jm[p] for p in shared])
    ti = np.array([tm[p] for p in shared])
    assert np.abs(np.asarray(jk.xy)[ji] - tk.xy.numpy()[ti]).max() <= 1e-3
    js, ts = np.asarray(jk.score)[ji], tk.score.numpy()[ti]
    assert (np.abs(js - ts) <= 1e-4 * np.abs(js)).all()
    assert np.abs(np.asarray(jk.angle)[ji] - tk.angle.numpy()[ti]).max() \
        <= 1e-3
    assert np.array_equal(np.asarray(jk.size)[ji], tk.size.numpy()[ti])
    bits = np.asarray(jd)[ji] == td.numpy()[ti]
    assert bits.all(axis=1).mean() >= 0.99 and bits.mean() >= 0.999
    assert td.shape == (256, 256)
    assert set(np.unique(td.numpy())) == {-1 / 16, 1 / 16}


def test_detect_and_describe_recovers_rotation_and_shift():
    """A 10-degree rotation plus a (3, 2) px shift, recovered through the
    port's matching and RANSAC (its own generator draws the samples)."""
    img = blobs(2, 240, 320)
    deg = 10.0
    m = cv2.getRotationMatrix2D((160, 120), deg, 1.0)
    m[:, 2] += (3.0, 2.0)
    rot = cv2.warpAffine(img, m, (320, 240), flags=cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REFLECT)
    k1, d1 = tak.detect_and_describe(T(img))
    k2, d2 = tak.detect_and_describe(T(rot))
    idx, good = tfs.match_descriptors(d1, d2, k1.score > 0, k2.score > 0)
    assert int(good.sum()) > 20
    h_mat, n_inl = tfs.ransac_homography(k1.xy, k2.xy[idx], good,
                                         tfs.step_generator(0, 0, "cpu"))
    assert int(n_inl) > 30
    h = h_mat.numpy()
    assert abs(np.degrees(np.arctan2(h[1, 0], h[0, 0])) + deg) < 0.5
    want = np.vstack([m, [0, 0, 1]])
    c = np.float64([[0, 0, 1], [320, 0, 1], [0, 240, 1], [320, 240, 1]])
    pa, pb = c @ np.float64(h).T, c @ want.T
    assert np.abs(pa[:, :2] / pa[:, 2:] - pb[:, :2]).max() < 1.5


def test_stabilize_pair_akaze_matches_jax():
    a = blobs(3)
    m = np.float32([[1, 0, 4.3], [0, 1, 2.6]])
    b = cv2.warpAffine(a, m, (W, H))
    frame = np.stack([b, b // 2, b], -1)
    key = jax.random.PRNGKey(1)
    noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (256,)))(
        jax.random.split(key, 64)))
    jout, jh, jn = jfs.stabilize_pair(J(a), J(b), J(frame), key,
                                      features="akaze")
    tout, th, tn = tfs.stabilize_pair(T(a), T(b), T(frame), noise=T(noise),
                                      features="akaze")
    assert int(jn) > 20 and abs(int(tn) - int(jn)) <= 0.02 * int(jn)
    c = np.float64([[0, 0, 1], [W, 0, 1], [0, H, 1], [W, H, 1]])
    pa, pb = c @ np.float64(th.numpy()).T, c @ np.float64(jh).T
    assert np.abs(pa[:, :2] / pa[:, 2:] - pb[:, :2] / pb[:, 2:]).max() \
        <= 0.01
    disp = tfs.homography_displacement(th, H, W).numpy()
    jdisp = np.asarray(jfs.homography_displacement(jh, H, W))

    def inside(d):
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        x1, y1 = np.floor(xs + d[..., 0]), np.floor(ys + d[..., 1])
        return (x1 >= 0) & (y1 >= 0) & (x1 < W - 1) & (y1 < H - 1)
    keep = inside(disp) == inside(jdisp)
    assert (~keep).sum() <= H + W
    d = np.abs(tout.numpy().astype(int) -
               np.asarray(jout).astype(int)).max(-1)[keep]
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())
