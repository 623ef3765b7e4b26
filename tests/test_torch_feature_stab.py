"""The port's feature stabilizer (``flow/feature_stab.py``) against the
JAX package, on the CPU, on the same numpy inputs made from a seed.

RANSAC's samples come from JAX's own stream: the tests recompute the
per-trial Gumbel noise (``jax.random.split`` / ``gumbel``) or the
selections (``top_k`` of it) that JAX draws from a key and hand them to
the port. Tolerances, as measured at 120x160:

- Harris corners: the valid ones (score > 0) compared as sets, >= 99% at
  the same pixel, shared scores within rtol 1e-5 (measured: all equal);
  padded (-inf) entries may be ordered otherwise by ``torch.topk``;
- patch descriptors of shared corners within 1e-5; matches (index and
  ``good``) equal on >= 99% of the valid corners;
- ``_dlt_homography`` and the refined RANSAC homography: the four image
  corners mapped within H_PX px (LAPACK's SVD against XLA's; measured
  ~2e-5 px); ``_apply_h`` within 5e-5 px (a few float32 ULPs of
  coordinates below 200 px: another product order); inlier counts equal;
- ``warp_by_homography`` at C = 3 and C = 1 (the same H): at most
  PIXEL_SHARE of pixels differ, by at most one uint8 level (measured:
  equal); ``stabilize_pair``'s corrected frame likewise, leaving out the
  pixels whose sample crosses the frame's edge between the two H (0 on
  one side): the integer shift of the test puts a column of samples
  within ~1e-5 px of the edge, so the two SVDs' H put it on either side
  (measured: 183 such pixels of 19200, a row and a column; the rest
  equal);
- RANSAC with collinear samples among its trials (a null space of two
  dimensions: no single H for them): the refined H within H_PX and the
  inlier count equal, as long as a trial in general position wins.
"""

import numpy as np
import torch

import cv2
import jax
import jax.numpy as jnp

from ripcurrents_tpu.flow import feature_stab as jfs
from ripcurrents_tpu_torch.flow import feature_stab as tfs

torch.set_num_threads(1)

H, W = 120, 160
H_PX = 1e-3
PIXEL_SHARE = 1e-3
T = torch.from_numpy
J = jnp.asarray


def textured(seed, h=H, w=W):
    """Box-smoothed noise with sprinkled 4x4 squares (the JAX test's
    ``_textured``)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w)).astype(np.float32)
    k = np.ones(3) / 3
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    for _ in range(60):
        y, x = rng.integers(10, h - 10), rng.integers(10, w - 10)
        base[y:y + 4, x:x + 4] = 255 * rng.integers(0, 2)
    return base.astype(np.uint8)


def moved(img, dx, dy, deg=0.0):
    m = cv2.getRotationMatrix2D((img.shape[1] / 2, img.shape[0] / 2), deg,
                                1.0)
    m[:, 2] += (dx, dy)
    return cv2.warpAffine(img, m, (img.shape[1], img.shape[0]))


def jax_noise(key, n, trials=64):
    """The Gumbel noise JAX's ransac_homography draws from `key`."""
    keys = jax.random.split(key, trials)
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(keys))


def jax_sel(noise, good):
    g = J(noise) + jnp.where(J(good), 0.0, -1e9)[None, :]
    return np.asarray(jax.lax.top_k(g, 4)[1])


def corner_px(h_a, h_b, h=H, w=W):
    """Largest distance (px) between the images of the frame's corners
    under two homographies."""
    c = np.float64([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]])
    pa, pb = c @ np.float64(h_a).T, c @ np.float64(h_b).T
    return np.abs(pa[:, :2] / pa[:, 2:] - pb[:, :2] / pb[:, 2:]).max()


def inside(disp):
    """Where warp_by_homography's sample of each pixel lies inside the
    frame, from its float32 displacement (H, W, 2)."""
    h, w = disp.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    x1 = np.floor(xs + disp[..., 0])
    y1 = np.floor(ys + disp[..., 1])
    return (x1 >= 0) & (y1 >= 0) & (x1 < w - 1) & (y1 < h - 1)


def frames_close(got, want, h_got=None, h_want=None):
    """At most PIXEL_SHARE of pixels differ, by one uint8 level at most;
    given the two homographies (port's, JAX's), the pixels whose sample
    lies inside the frame under one and outside under the other (0 on
    one side) are left out; at most a row and a column of them."""
    d = np.abs(got.astype(int) - np.asarray(want).astype(int))
    if d.ndim == 3:
        d = d.max(-1)
    keep = np.ones(d.shape, bool)
    if h_got is not None:
        keep = inside(tfs.homography_displacement(T(h_got), *d.shape)
                      .numpy()) == \
            inside(np.asarray(jfs.homography_displacement(J(h_want),
                                                          *d.shape)))
    assert (~keep).sum() <= sum(d.shape)
    d = d[keep]
    assert d.max() <= 1 and (d > 0).mean() <= PIXEL_SHARE, \
        (d.max(), (d > 0).mean())


def test_harris_descriptors_and_matching_match_jax():
    a = textured(0)
    b = moved(a, 3.0, -2.0, 2.0)
    jc = [jfs.harris_corners(J(x)) for x in (a, b)]
    tc = [tfs.harris_corners(T(x)) for x in (a, b)]
    for j, t in zip(jc, tc):
        jv, tv = np.asarray(j.score) > 0, t.score.numpy() > 0
        assert 60 < jv.sum() and jv.sum() == tv.sum()
        jxy = {tuple(p): s for p, s in zip(np.asarray(j.xy)[jv],
                                           np.asarray(j.score)[jv])}
        txy = {tuple(p): s for p, s in zip(t.xy.numpy()[tv],
                                           t.score.numpy()[tv])}
        shared = set(jxy) & set(txy)
        assert len(shared) >= 0.99 * len(jxy)
        for p in shared:
            assert abs(jxy[p] - txy[p]) <= 1e-5 * abs(jxy[p])
    jd = [jfs.patch_descriptors(J(x), c.xy) for x, c in zip((a, b), jc)]
    td = [tfs.patch_descriptors(T(x), c.xy) for x, c in zip((a, b), tc)]
    for x, j, t, c in zip((a, b), jd, td, tc):
        v = c.score.numpy() > 0
        assert np.abs(np.asarray(j)[v] - t.numpy()[v]).max() <= 1e-5
        # all N patches at once equal a per-corner crop
        xy = c.xy.numpy()[v][:5].astype(int)
        for i, (px, py) in enumerate(xy):
            y0 = min(max(py - 4, 0), H - 8)
            x0 = min(max(px - 4, 0), W - 8)
            p = x[y0:y0 + 8, x0:x0 + 8].astype(np.float32).reshape(-1)
            p -= p.mean()
            p /= max(np.sqrt((p * p).mean()), 1e-3)
            assert np.abs(t.numpy()[v][i] - p).max() <= 1e-5
    ji, jg = jfs.match_descriptors(jd[0], jd[1], jc[0].score > 0,
                                   jc[1].score > 0)
    ti, tg = tfs.match_descriptors(td[0], td[1], tc[0].score > 0,
                                   tc[1].score > 0)
    va = tc[0].score.numpy() > 0
    same = (np.asarray(jg) == tg.numpy()) & \
        (~tg.numpy() | (np.asarray(ji) == ti.numpy()))
    assert same[va].mean() >= 0.99 and tg.sum() > 30


def test_dlt_and_ransac_match_jax_on_its_samples():
    rng = np.random.default_rng(1)
    true = np.float32([[1.01, 0.02, 3.0], [-0.015, 0.99, -2.0],
                       [1e-5, -2e-5, 1.0]])
    src = rng.uniform(0, [W, H], (200, 2)).astype(np.float32)
    q = np.c_[src, np.ones(200, np.float32)] @ true.T
    dst = (q[:, :2] / q[:, 2:]).astype(np.float32)
    dst += rng.normal(0, 0.3, dst.shape).astype(np.float32)
    dst[:40] += rng.uniform(-30, 30, (40, 2)).astype(np.float32)  # outliers
    good = rng.uniform(size=200) < 0.9
    w = rng.uniform(0.5, 1.5, 200).astype(np.float32)
    jh = np.asarray(jfs._dlt_homography(J(src), J(dst), J(w)))
    th = tfs._dlt_homography(T(src), T(dst), T(w)).numpy()
    assert corner_px(jh / jh[2, 2], th / th[2, 2]) <= H_PX
    assert np.abs(np.asarray(jfs._apply_h(J(jh), J(src))) -
                  tfs._apply_h(T(jh), T(src)).numpy()).max() <= 5e-5
    pn, s, c = tfs._hartley(T(src), T(w))
    jn, jt = jfs._hartley(J(src), J(w))
    assert np.abs(pn.numpy() - np.asarray(jn)).max() <= 1e-5
    assert np.allclose(tfs._similarity(s, -s * c[0], -s * c[1]).numpy(),
                       np.asarray(jt), rtol=1e-6, atol=1e-6)
    # the batched DLT of RANSAC's trials equals one solve per trial
    sel = rng.integers(40, 200, (6, 4))
    hs = tfs._dlt_homography(T(src)[sel], T(dst)[sel], torch.ones(6, 4))
    for i in range(6):
        one = tfs._dlt_homography(T(src[sel[i]]), T(dst[sel[i]]),
                                  torch.ones(4)).numpy()
        assert corner_px(hs[i].numpy() / hs[i, 2, 2].item(),
                         one / one[2, 2]) <= H_PX

    key = jax.random.PRNGKey(7)
    jh, jn = jfs.ransac_homography(J(src), J(dst), J(good), key)
    noise = jax_noise(key, 200)
    th, tn = tfs.ransac_homography(T(src), T(dst), T(good), noise=T(noise))
    th2, tn2 = tfs.ransac_homography(T(src), T(dst), T(good),
                                     sel=T(jax_sel(noise, good)))
    for h, n in ((th, tn), (th2, tn2)):
        assert int(n) == int(jn) > 100
        assert corner_px(h.numpy(), np.asarray(jh)) <= H_PX
    assert corner_px(th.numpy(), true) <= 0.5
    # the generator draw: the same seed and step give the same samples
    g1, g2 = (tfs.step_generator(0, 3, "cpu") for _ in range(2))
    assert torch.equal(tfs.ransac_homography(T(src), T(dst), T(good), g1)[0],
                       tfs.ransac_homography(T(src), T(dst), T(good), g2)[0])
    _degenerate_samples_match_jax(src, true)


def jax_ransac_on(src, dst, good, sel, thresh=2.0):
    """JAX's ransac_homography on the given samples `sel` (trials, 4): its
    trial, vote and refinement, made of its own functions. -> (H, inlier
    count, every trial's count)."""
    s, d, g = J(src), J(dst), J(good)
    hs = jax.vmap(lambda k: jfs._dlt_homography(s[k], d[k], jnp.ones(4)))(
        J(sel))
    err = jnp.sum((jax.vmap(lambda h: jfs._apply_h(h, s))(hs) - d) ** 2, -1)
    inl = (err < thresh * thresh) & g
    counts = inl.sum(1)
    best = jnp.argmax(counts)
    h = jfs._dlt_homography(s, d, inl[best].astype(jnp.float32) +
                            1e-6 * g.astype(jnp.float32))
    h = h / jnp.where(jnp.abs(h[2, 2]) > 1e-9, h[2, 2], 1.0)
    return np.asarray(h), int(counts[best]), np.asarray(counts)


def _degenerate_samples_match_jax(src, true):
    """RANSAC with collinear 4-point samples: 20 of the points lie on one
    line and three of five trials draw 4 of them. A collinear sample's
    8 x 9 system has a null space of two dimensions, so the two SVDs may
    return any vector of it: those trials' H and votes differ (no single
    answer), but a trial of points in general position wins on both
    sides and the refined H and its inlier count agree as before. With
    every trial collinear the answers differ (``ROADMAP.md`` queue 3)."""
    src = src.copy()
    src[:20, 0] = np.linspace(5, 150, 20, dtype=np.float32)
    src[:20, 1] = 0.5 * src[:20, 0] + 10
    q = np.c_[src, np.ones(len(src), np.float32)] @ true.T
    dst = (q[:, :2] / q[:, 2:]).astype(np.float32)
    good = np.ones(len(src), bool)
    sel = np.array([[0, 5, 10, 15], [1, 6, 11, 19], [30, 60, 90, 120],
                    [2, 3, 4, 7], [40, 80, 150, 199]])
    jh, jn, jc = jax_ransac_on(src, dst, good, sel)
    th, tn = tfs.ransac_homography(T(src), T(dst), T(good), sel=T(sel))
    assert int(tn) == jn == len(src)
    assert corner_px(th.numpy(), jh) <= H_PX
    assert corner_px(th.numpy(), true) <= 0.01
    assert jc[2] == jc[4] == len(src)
    # the collinear samples' DLT systems: two singular values ~0
    for k in sel[[0, 1, 3]]:
        x, y = src[k, 0].astype(np.float64), src[k, 1].astype(np.float64)
        u, v = dst[k, 0].astype(np.float64), dst[k, 1].astype(np.float64)
        o, z = np.ones(4), np.zeros(4)
        a = np.concatenate([np.stack([x, y, o, z, z, z, -u * x, -u * y, -u],
                                     1),
                            np.stack([z, z, z, x, y, o, -v * x, -v * y, -v],
                                     1)])
        sv = np.linalg.svd(a, compute_uv=False)
        assert sv[-1] / sv[0] < 1e-9 and sv[-2] / sv[0] < 1e-9, sv


def test_warp_by_homography_matches_jax():
    a = textured(2)
    frame = np.stack([a, np.roll(a, 5, 0), 255 - a], -1)
    ang = np.deg2rad(1.0)
    h = np.float32([[np.cos(ang), -np.sin(ang), 3.0],
                    [np.sin(ang), np.cos(ang), 2.0], [1e-5, 0.0, 1.0]])
    for f in (frame, a):
        want = np.asarray(jfs.warp_by_homography(J(f), J(h)))
        got = tfs.warp_by_homography(T(f), T(h)).numpy()
        assert got.shape == f.shape and got.dtype == np.uint8
        frames_close(got, want)
    d = tfs.homography_displacement(T(h), H, W)
    assert d.is_contiguous() and d.shape == (H, W, 2)
    assert np.abs(d.numpy() - np.asarray(
        jfs.homography_displacement(J(h), H, W))).max() <= 1e-4


def test_stabilize_pair_harris_matches_jax():
    a = textured(3)
    b = moved(a, 4.0, 3.0)
    frame = np.stack([b, b, b], -1)
    key = jax.random.PRNGKey(1)
    jout, jh, jn = jfs.stabilize_pair(J(a), J(b), J(frame), key)
    tout, th, tn = tfs.stabilize_pair(T(a), T(b), T(frame),
                                      noise=T(jax_noise(key, 256)))
    assert int(tn) == int(jn) > 30
    assert corner_px(th.numpy(), np.asarray(jh)) <= H_PX
    frames_close(tout.numpy(), jout, th.numpy(), jh)
    sl = np.s_[20:-20, 20:-20]
    before = np.abs(b.astype(int) - a.astype(int))[sl].mean()
    after = np.abs(tout.numpy()[..., 0].astype(int) - a.astype(int))[sl].mean()
    assert after < 0.3 * before
    # fewer than 8 inliers (a flat frame has no corner): the identity
    flat = np.full_like(a, 90)
    jout, jh, jn = jfs.stabilize_pair(J(flat), J(b), J(frame), key)
    tout, th, tn = tfs.stabilize_pair(T(flat), T(b), T(frame),
                                      noise=T(jax_noise(key, 256)))
    assert int(tn) == int(jn) < 8
    assert torch.equal(th, torch.eye(3)) and np.array_equal(np.asarray(jh),
                                                            np.eye(3))
    frames_close(tout.numpy(), jout)
    # the identity warp leaves the frame, bar the last row and column,
    # whose samples' floor lands on the frame's edge (not "inside")
    assert np.array_equal(tout.numpy()[:-1, :-1], frame[:-1, :-1])
