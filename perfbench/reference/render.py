"""Plain PyTorch reference of the decoder: Gaussians -> one rendered view.

Preprocessing (projection, EWA 2D covariance with the 0.3 px dilation,
opacity-aware 3-sigma radius, SH colors) is a frozen copy of the port's.
Compositing is this file's own: each Gaussian goes to every 16x16 tile its
radius rectangle touches, sorted front to back per tile (the Gaussian's
index breaks depth ties), and every tile's pixels are blended densely over
its padded list, a block of tiles at a time:

- a pair is cut where its power is positive or alpha < 1/255, with alpha
  = min(opacity exp(power), 0.99);
- T_j is the product of (1 - alpha) over the pairs blended before j;
- the first uncut pair whose blend would take T below 1e-4 is not blended
  and ends the pixel.

``composite`` also counts the (pixel, Gaussian) pairs these rules visit,
for the rasterizer's roofline (``perfbench/roofline/raster.py``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

TILE = 16
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
# Elements of one (tiles, pixels, instances) block.
BLOCK_ELEMENTS = 24_000_000


def eval_sh(sh, dirs, degree: int):
    """sh (n, 3, d_sh), unit dirs (n, 3) -> (n, 3), degrees 0..2."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    basis = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        basis += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy),
                  SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    if degree >= 3:
        raise ValueError("the reference evaluates SH degrees 0 to 2")
    return (sh * torch.stack(basis, dim=-1)[:, None, :]).sum(-1)


def _fov(intr):
    inv = torch.linalg.inv(intr)

    def ray(vec):
        v = inv @ torch.tensor(vec, dtype=intr.dtype, device=intr.device)
        return v / torch.linalg.norm(v)

    left, right = ray([0.0, 0.5, 1.0]), ray([1.0, 0.5, 1.0])
    top, bottom = ray([0.5, 0.0, 1.0]), ray([0.5, 1.0, 1.0])
    return (torch.arccos(torch.clamp((left * right).sum(), -1.0, 1.0)),
            torch.arccos(torch.clamp((top * bottom).sum(), -1.0, 1.0)))


def preprocess(means, covs, harmonics, opacities, extrinsics, intrinsics, image_shape,
               sh_degree: int, eps: float = 1e-7):
    """Per Gaussian: means2d (n, 2) px, conics (n, 3), colors (n, 3),
    opacities (n,), depths (n,), radii (n,), mask (n,) bool."""
    h, w = image_shape
    fov_x, fov_y = _fov(intrinsics)
    tan_x, tan_y = torch.tan(0.5 * fov_x), torch.tan(0.5 * fov_y)
    focal_x, focal_y = w / (2.0 * tan_x), h / (2.0 * tan_y)
    w2c = torch.linalg.inv(extrinsics)
    means_h = torch.cat([means, torch.ones_like(means[:, :1])], dim=-1)
    cam = (means_h @ w2c.T)[:, :3]
    depths = cam[:, 2]
    front = depths > 0.2
    tz = torch.where(front, depths, 1.0)
    # Perspective projection (near 0.01, far 100; only x, y and w are read).
    zero = torch.zeros((), dtype=means.dtype, device=means.device)
    near = torch.full((), 0.01, dtype=means.dtype, device=means.device)
    far = torch.full((), 100.0, dtype=means.dtype, device=means.device)
    top, right = tan_y * near, tan_x * near
    proj = torch.stack([
        torch.stack([2 * near / (2 * right), zero, zero, zero]),
        torch.stack([zero, 2 * near / (2 * top), zero, zero]),
        torch.stack([zero, zero, far / (far - near), -(far * near) / (far - near)]),
        torch.stack([zero, zero, torch.ones_like(zero), zero]),
    ])
    p_hom = means_h @ (proj @ w2c).T
    p_w = 1.0 / torch.where(front, p_hom[:, 3] + eps, 1.0)
    ndc = p_hom[:, :2] * p_w[:, None]
    means2d = torch.stack([((ndc[:, 0] + 1.0) * w - 1.0) * 0.5,
                           ((ndc[:, 1] + 1.0) * h - 1.0) * 0.5], dim=-1)
    lim_x, lim_y = 1.3 * tan_x, 1.3 * tan_y
    tx = torch.minimum(torch.maximum(cam[:, 0] / tz, -lim_x), lim_x) * tz
    ty = torch.minimum(torch.maximum(cam[:, 1] / tz, -lim_y), lim_y) * tz
    j00, j02 = focal_x / tz, -(focal_x * tx) / (tz * tz)
    j11, j12 = focal_y / tz, -(focal_y * ty) / (tz * tz)
    rot = w2c[:3, :3]
    jw0 = j00[:, None] * rot[0][None, :] + j02[:, None] * rot[2][None, :]
    jw1 = j11[:, None] * rot[1][None, :] + j12[:, None] * rot[2][None, :]
    c00, c01, c02 = covs[:, 0, 0], covs[:, 0, 1], covs[:, 0, 2]
    c11, c12, c22 = covs[:, 1, 1], covs[:, 1, 2], covs[:, 2, 2]

    def quad(u, v):
        return (u[:, 0] * (c00 * v[:, 0] + c01 * v[:, 1] + c02 * v[:, 2])
                + u[:, 1] * (c01 * v[:, 0] + c11 * v[:, 1] + c12 * v[:, 2])
                + u[:, 2] * (c02 * v[:, 0] + c12 * v[:, 1] + c22 * v[:, 2]))

    a = quad(jw0, jw0) + 0.3
    b = quad(jw0, jw1)
    c = quad(jw1, jw1) + 0.3
    det = a * c - b * b
    ok = det > 0.0
    det_safe = torch.where(ok, det, 1.0)
    conics = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)
    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    k_sigma = torch.clamp(torch.sqrt(2.0 * torch.clamp(
        torch.log(torch.clamp(opacities, min=1e-12) / ALPHA_MIN), min=0.0)), max=3.0).detach()
    radii = torch.ceil(k_sigma * torch.sqrt(torch.clamp(lambda1, min=0.0)))
    dirs = means - extrinsics[:3, 3]
    dirs = dirs / torch.sqrt((dirs * dirs).sum(-1, keepdim=True) + 1e-12)
    colors = torch.clamp(eval_sh(harmonics, dirs, sh_degree) + 0.5, min=0.0)
    mask = front & ok & (radii > 0)
    return {"means2d": means2d, "conics": conics, "colors": colors, "opacities": opacities,
            "depths": depths, "radii": torch.where(mask, radii, 0.0), "mask": mask}


@torch.no_grad()
def bin_tiles(screen, image_shape):
    """Each visible Gaussian into every tile of its radius rectangle, sorted
    by (tile, depth, index): (gid (k,), tile_start (t,), tile_count (t,),
    Gaussians that touch a tile)."""
    h, w = image_shape
    th, tw = -(-h // TILE), -(-w // TILE)
    mx, my = screen["means2d"][:, 0], screen["means2d"][:, 1]
    r = screen["radii"]
    x0 = torch.clamp(torch.floor((mx - r) / TILE), 0, tw).long()
    y0 = torch.clamp(torch.floor((my - r) / TILE), 0, th).long()
    x1 = torch.clamp(torch.floor((mx + r + TILE - 1) / TILE), 0, tw).long()
    y1 = torch.clamp(torch.floor((my + r + TILE - 1) / TILE), 0, th).long()
    count = torch.where(screen["mask"], (x1 - x0) * (y1 - y0), 0)
    n = count.shape[0]
    gid = torch.repeat_interleave(torch.arange(n, device=count.device), count)
    local = torch.arange(gid.shape[0], device=count.device) - (torch.cumsum(count, 0) - count)[gid]
    span = torch.clamp(x1 - x0, min=1)[gid]
    tile = (y0[gid] + local // span) * tw + x0[gid] + local % span
    by_depth = torch.sort(screen["depths"][gid], stable=True).indices
    gid, tile = gid[by_depth], tile[by_depth]
    by_tile = torch.sort(tile, stable=True).indices
    gid, tile = gid[by_tile], tile[by_tile]
    tile_count = torch.bincount(tile, minlength=th * tw)
    return gid, torch.cumsum(tile_count, 0) - tile_count, tile_count, int((count > 0).sum())


def _blend_block(d, live, px, py):
    """One block of tiles: d (T, K, 10) instance rows, live (T, K), pixel
    coordinates (T, P) -> (rgbd (T, P, 4), log T (T, P), masks)."""
    dx = px[:, :, None] - d[:, None, :, 0]  # (T, P, K)
    dy = py[:, :, None] - d[:, None, :, 1]
    power = (-0.5 * (d[:, None, :, 2] * dx * dx + d[:, None, :, 4] * dy * dy)
             - d[:, None, :, 3] * dx * dy)
    alpha = torch.clamp(d[:, None, :, 5] * torch.exp(power), max=ALPHA_MAX)
    cut = (power > 0.0) | (alpha < ALPHA_MIN) | ~live[:, None, :]
    log_one_minus = torch.log1p(-torch.where(cut, 0.0, alpha))
    log_t = torch.cat([torch.zeros_like(log_one_minus[..., :1]),
                       torch.cumsum(log_one_minus, dim=-1)[..., :-1]], dim=-1)  # exclusive
    stop = ~cut & (torch.exp(log_t + log_one_minus) < T_EPS)
    ended = torch.cumsum(stop.to(torch.int32), dim=-1)  # stops at or before j
    blend = ~cut & (ended == 0)
    weight = torch.where(blend, alpha * torch.exp(log_t), 0.0)
    rgbd = torch.stack([(weight * d[:, None, :, 6 + ch]).sum(-1) for ch in range(4)], dim=-1)
    log_final = torch.where(blend, log_one_minus, 0.0).sum(-1)
    return rgbd, log_final, (stop, ended, blend)


def _blend_outputs(d, live, px, py):
    rgbd, log_final, _ = _blend_block(d, live, px, py)
    return rgbd, log_final


def composite(screen, image_shape, background, count_pairs: bool = False):
    """-> (color (h, w, 3), unnormalized depth (h, w), alpha (h, w)) and,
    with ``count_pairs``, the pair counts: ``evaluated`` (pairs visited up
    to and including the one that ends a pixel), ``blended``, ``stopped``
    and ``walked`` (per pixel, its list up to its last blended pair), with
    ``rows`` (Gaussians that touch a tile) and ``pixels``.
    With a gradient, each block is recomputed in the backward
    (``torch.utils.checkpoint``) rather than kept."""
    h, w = image_shape
    th, tw = -(-h // TILE), -(-w // TILE)
    dev = screen["means2d"].device
    gid, start, count, touching = bin_tiles(screen, image_shape)
    if gid.numel() == 0:  # nothing in view: one dummy row that no pixel reads
        gid = torch.zeros(1, dtype=torch.long, device=dev)
    rows = torch.cat([screen["means2d"], screen["conics"], screen["opacities"][:, None],
                      screen["colors"], screen["depths"][:, None]], dim=-1)  # (n, 10)
    pix = torch.arange(TILE * TILE, device=dev)
    grad = torch.is_grad_enabled() and rows.requires_grad
    out_rgbd, out_t = [], []
    counts = {"evaluated": 0, "blended": 0, "stopped": 0, "walked": 0, "rows": touching,
              "pixels": h * w}
    k_all = count.tolist()
    t = 0
    while t < th * tw:
        k = max(k_all[t], 1)
        t1 = t + 1
        while t1 < th * tw and (t1 - t + 1) * TILE * TILE * max(k, k_all[t1]) <= BLOCK_ELEMENTS:
            k = max(k, k_all[t1])
            t1 += 1
        tiles = torch.arange(t, t1, device=dev)
        slot = torch.arange(k, device=dev)
        live = slot[None, :] < count[t:t1, None]  # (T, K)
        d = rows[gid[torch.where(live, start[t:t1, None] + slot[None, :], 0)]]  # (T, K, 10)
        px = ((tiles % tw) * TILE)[:, None].float() + (pix % TILE).float()[None, :]
        py = ((tiles // tw) * TILE)[:, None].float() + (pix // TILE).float()[None, :]
        if grad:
            rgbd, log_final = checkpoint(_blend_outputs, d, live, px, py, use_reentrant=False)
        else:
            rgbd, log_final, (stop, ended, blend) = _blend_block(d, live, px, py)
            if count_pairs:  # the image's pixels only: a tile may reach past its edge
                inside = ((px < w) & (py < h))[:, :, None]
                visited = inside & live[:, None, :] & ((ended - stop.to(torch.int32)) == 0)
                counts["evaluated"] += int(visited.sum())
                counts["blended"] += int((blend & inside).sum())
                counts["stopped"] += int((stop & inside).sum())
                last = torch.where(blend & inside, slot + 1, 0).amax(-1)
                counts["walked"] += int(last.sum())
        out_rgbd.append(rgbd)
        out_t.append(log_final)
        t = t1
    rgbd = torch.cat(out_rgbd).reshape(th, tw, TILE, TILE, 4).permute(0, 2, 1, 3, 4)
    rgbd = rgbd.reshape(th * TILE, tw * TILE, 4)[:h, :w]
    t_final = torch.exp(torch.cat(out_t).reshape(th, tw, TILE, TILE).permute(0, 2, 1, 3)
                        .reshape(th * TILE, tw * TILE)[:h, :w])
    color = rgbd[..., :3] + t_final[..., None] * background
    result = (color, rgbd[..., 3], 1.0 - t_final)
    return (result, counts) if count_pairs else result


def render_view(gaussians, extrinsics, intrinsics, near, image_shape, sh_degree: int,
                count_pairs: bool = False):
    """One target view as the port's decoder renders it (the scene scaled by
    1/near, black background, depth normalized by alpha): (color (h, w, 3),
    depth (h, w)) and, with ``count_pairs``, (screen, counts) besides."""
    s = 1.0 / near
    extr = extrinsics.clone()
    extr[:3, 3] = extr[:3, 3] * s
    opac = torch.where(gaussians["mask"], gaussians["opacities"], 0.0)
    screen = preprocess(gaussians["means"] * s, gaussians["covariances"] * (s * s),
                        gaussians["harmonics"], opac, extr, intrinsics, image_shape, sh_degree)
    bg = torch.zeros(3, device=extr.device)
    out = composite(screen, image_shape, bg, count_pairs=count_pairs)
    (color, depth_acc, alpha), counts = out if count_pairs else (out, None)
    depth = depth_acc * near / torch.clamp(alpha, min=1e-6)
    return (color, depth, screen, counts) if count_pairs else (color, depth)


def render_input(means, covs, harmonics, opacities, extrinsics, intrinsics, image_shape):
    """An input frame of a synthetic scene (degree-0 SH, black background,
    no rescale): (color clipped to [0, 1], alpha-normalized depth)."""
    screen = preprocess(means, covs, harmonics, opacities, extrinsics, intrinsics,
                        image_shape, 0)
    color, depth, alpha = composite(screen, image_shape, torch.zeros(3, device=means.device))
    return torch.clamp(color, 0.0, 1.0), depth / torch.clamp(alpha, min=1e-6)


def ssim(gt, pred, win: int = 11, sigma: float = 1.5):
    """(b, h, w, c) in [0, 1] -> (b,) mean SSIM, skimage's gaussian-window
    definition (valid windows, unbiased covariances)."""
    gt = torch.clamp(gt, 0.0, 1.0)
    pred = torch.clamp(pred, 0.0, 1.0)
    b, h, w, c = gt.shape
    offs = torch.arange(win, dtype=torch.float64) - (win - 1) / 2.0
    k = torch.exp(-0.5 * (offs / sigma) ** 2)
    k = (k / k.sum())
    kernel = torch.outer(k, k).float().to(gt.device)[None, None]

    def filt(x):
        return torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).reshape(b * c, 1, h, w), kernel)

    mu_x, mu_y = filt(gt), filt(pred)
    n = win * win
    vx = n / (n - 1.0) * (filt(gt * gt) - mu_x * mu_x)
    vy = n / (n - 1.0) * (filt(pred * pred) - mu_y * mu_y)
    vxy = n / (n - 1.0) * (filt(gt * pred) - mu_x * mu_y)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    smap = ((2 * mu_x * mu_y + c1) * (2 * vxy + c2)) / ((mu_x ** 2 + mu_y ** 2 + c1) * (vx + vy + c2))
    return smap.reshape(b, -1).mean(dim=1)


def psnr(gt, pred):
    """(b, h, w, c) -> (b,) PSNR in dB, inputs clipped to [0, 1]."""
    mse = ((torch.clamp(gt, 0, 1) - torch.clamp(pred, 0, 1)) ** 2).mean(dim=(-1, -2, -3))
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))

