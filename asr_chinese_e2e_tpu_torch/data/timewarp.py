"""SpecAugment time-warp: polyharmonic-spline sparse image warp in torch
(``asr_chinese_e2e_tpu/data/timewarp.py``).

The JAX package computes it in plain ``jnp`` (no Pallas kernel), and so
does this module: per utterance one small linear solve (13 control points
plus the affine part) and one (T·D, N) kernel product for the dense flow,
then a bilinear resample by four gathers. The flow is computed in float64
(``sparse_image_warp`` says why); the resample in the features' dtype. The batch is one batched solve
and one batched product; the draws come from a CPU ``torch.Generator``
(``draw_warps``), and ``warp_at`` takes explicit centers and shifts, so a
test can feed the JAX package's draws.
"""

from __future__ import annotations

import torch


def _phi(r2: torch.Tensor) -> torch.Tensor:
    """Order-2 polyharmonic kernel phi(r) = r^2 log(r) = 0.5 r^2 log(r^2),
    with the removable singularity at r=0 handled exactly."""
    return 0.5 * r2 * torch.log(r2.clamp(min=1e-12))


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 2), (..., N, 2) -> (..., M, N) squared distances."""
    return ((a[..., :, None, 0] - b[..., None, :, 0]) ** 2
            + (a[..., :, None, 1] - b[..., None, :, 1]) ** 2)


def _affine(points: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) -> (..., N, 3) rows [1, t, d]."""
    return torch.cat([torch.ones_like(points[..., :1]), points], dim=-1)


def interpolate_spline(
    train_points: torch.Tensor,  # (..., N, 2) control locations
    train_values: torch.Tensor,  # (..., N, V) values at the controls
    query_points: torch.Tensor,  # (..., M, 2)
    regularization: float = 0.0,
) -> torch.Tensor:
    """Thin-plate (order-2 polyharmonic) spline interpolation, batched over
    leading dims: fits w, v in f(x) = sum_i w_i phi(|x - c_i|) + v^T [1, x]
    by the standard saddle system and returns f(query) (..., M, V)."""
    n = train_points.shape[-2]
    a = _phi(_sq_dist(train_points, train_points))
    a = a + regularization * torch.eye(n, dtype=a.dtype, device=a.device)
    b = _affine(train_points)  # (..., N, 3)
    zeros = b.new_zeros(b.shape[:-2] + (3, 3))
    lhs = torch.cat([torch.cat([a, b], -1), torch.cat([b.transpose(-1, -2), zeros], -1)], -2)
    rhs = torch.cat([train_values, train_values.new_zeros(
        train_values.shape[:-2] + (3, train_values.shape[-1]))], dim=-2)
    wv = torch.linalg.solve_ex(lhs, rhs)[0]  # (..., N+3, V); no error check, no sync
    w, v = wv[..., :n, :], wv[..., n:, :]
    return _phi(_sq_dist(query_points, train_points)) @ w + _affine(query_points) @ v


def _grid(t: int, d: int, dtype, device):
    return torch.meshgrid(
        torch.arange(t, dtype=dtype, device=device),
        torch.arange(d, dtype=dtype, device=device),
        indexing="ij",
    )


def dense_image_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear resample out[..., t, d] = image[..., t - flow_t, d - flow_d]
    (the TF convention): ``image`` (..., T, D), ``flow`` (..., T, D, 2) in
    (t, d) order."""
    t, d = image.shape[-2:]
    grid_t, grid_d = _grid(t, d, flow.dtype, flow.device)
    qt = (grid_t - flow[..., 0]).clamp(0.0, t - 1.0)
    qd = (grid_d - flow[..., 1]).clamp(0.0, d - 1.0)
    t0 = qt.floor().long().clamp(0, t - 2)
    d0 = qd.floor().long().clamp(0, d - 2)
    ft = qt - t0
    fd = qd - d0
    flat = image.reshape(image.shape[:-2] + (t * d,))

    def g(ti, di):
        idx = (ti * d + di).reshape(ti.shape[:-2] + (t * d,))
        idx = idx.expand(flat.shape)
        return flat.gather(-1, idx).reshape(image.shape)

    top = g(t0, d0) * (1 - fd) + g(t0, d0 + 1) * fd
    bot = g(t0 + 1, d0) * (1 - fd) + g(t0 + 1, d0 + 1) * fd
    return top * (1 - ft) + bot * ft


def boundary_points(t: int, d: int, num_boundary_points: int) -> list:
    """TF's ``_get_boundary_locations`` without duplicates: the corners and
    ``num_boundary_points`` evenly spaced points per edge, (t, d) pairs
    (duplicate control points would make the spline system singular)."""
    n = num_boundary_points
    ys = [i * (t - 1.0) / (n + 1) for i in range(n + 2)]
    xs = [i * (d - 1.0) / (n + 1) for i in range(n + 2)]
    return [(y, x) for y in ys for x in xs
            if y in (0.0, t - 1.0) or x in (0.0, d - 1.0)]


def sparse_image_warp(
    image: torch.Tensor,  # (..., T, D)
    source_points: torch.Tensor,  # (..., N, 2) in (t, d)
    dest_points: torch.Tensor,  # (..., N, 2)
    num_boundary_points: int = 1,
    regularization: float = 0.0,
) -> torch.Tensor:
    """Warp so content at ``source_points`` moves to ``dest_points``;
    ``num_boundary_points`` anchors per edge (0 none, 1 corners, 2 corners
    and edge thirds, ...) pin the borders. The dense flow is the spline of
    the control displacements (dest - source, interpolated at dest),
    evaluated at every pixel, in float64 whatever the image's dtype: in f32
    the system of a T = 801-frame spectrogram (phi up to 4e6) loses up to
    2e-2 of the warped values, and the card and the CPU lose it
    differently."""
    t, d = image.shape[-2:]
    if num_boundary_points > 0:
        anchors = torch.tensor(boundary_points(t, d, num_boundary_points),
                               dtype=torch.float32, device=image.device)
        anchors = anchors.expand(source_points.shape[:-2] + anchors.shape)
        source_points = torch.cat([source_points, anchors], dim=-2)
        dest_points = torch.cat([dest_points, anchors], dim=-2)
    f64 = torch.float64
    displacements = dest_points.to(f64) - source_points.to(f64)
    grid_t, grid_d = _grid(t, d, f64, image.device)
    queries = torch.stack([grid_t.reshape(-1), grid_d.reshape(-1)], dim=1)  # (T*D, 2)
    flow = interpolate_spline(dest_points.to(f64), displacements, queries, regularization)
    return dense_image_warp(image, flow.reshape(image.shape + (2,)).to(image.dtype))


def draw_warps(generator: torch.Generator, feat_lengths: torch.Tensor, warp_param: int):
    """One warp per utterance, drawn on the CPU: center w0 ~ U[W, len-W)
    (at least one frame wide) and shift w ~ U{-W+1, ..., W-1}, W =
    ``warp_param``. Returns (centers (B,) f32, shifts (B,) int64)."""
    b = feat_lengths.shape[0]
    lens = feat_lengths.detach().cpu().to(torch.float32)
    lo = torch.full((b,), float(warp_param))
    hi = torch.maximum(lens - warp_param, lo + 1.0)
    u = torch.rand((b,), generator=generator)
    shifts = torch.randint(-warp_param + 1, warp_param, (b,), generator=generator)
    return lo + u * (hi - lo), shifts


def warp_at(feats: torch.Tensor, feat_lengths: torch.Tensor, centers, shifts) -> torch.Tensor:
    """Move frame ``centers[b]`` of utterance b to ``centers[b] + shifts[b]``
    (at the middle frequency, corners and edge thirds pinned), the
    spectrogram deforming smoothly around it; padding frames stay
    untouched. feats (B, T, D)."""
    b, t, d = feats.shape
    dev, dt = feats.device, feats.dtype
    centers = torch.as_tensor(centers).to(device=dev, dtype=dt)
    shifts = torch.as_tensor(shifts).to(device=dev, dtype=dt)
    mid = torch.full((b,), (d - 1) / 2.0, dtype=dt, device=dev)
    src = torch.stack([centers, mid], dim=-1)[:, None]  # (B, 1, 2)
    dst = torch.stack([centers + shifts, mid], dim=-1)[:, None]
    warped = sparse_image_warp(feats, src, dst, num_boundary_points=2)
    valid = torch.arange(t, device=dev)[None, :] < feat_lengths.to(dev)[:, None]
    return torch.where(valid[..., None], warped, feats)


def time_warp(feats, feat_lengths, generator: torch.Generator, warp_param: int):
    """SpecAugment time warp, one per utterance (``warp_param`` <= 0: the
    features as they are)."""
    if warp_param <= 0:
        return feats
    centers, shifts = draw_warps(generator, feat_lengths, warp_param)
    return warp_at(feats, feat_lengths, centers, shifts)
