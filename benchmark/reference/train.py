"""The plain reference of the two training steps: the geometry step (render,
L1 + SSIM, normal consistency, distortion, autograd, the densification
statistics, Adam) and the semantic step (features rendered at the drawn
pixels, single-view, 3D and multi-view ProtoNCE, autograd, Adam on the
features).

The losses, Adam and ProtoNCE are frozen copies of the program's plain
arithmetic at commit e06f678 (instascene_tpu_torch/losses.py
`photometric_loss`, `ssim`; ops/depth_utils.py `depth_to_normal`;
pipelines/train.py `rays_from_cam`, `geometry_loss_fn`; ops/rasterize.py
`densify_screen_grad`; models/densify.py `add_densification_stats`;
models/optimizer.py `adam_step`; semantic/contrastive.py
`contrastive_loss`). The render is benchmark/reference/render.py's. All
in the dtype of the inputs; nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import render as R

GEOMETRY_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                   "rotation", "opacity")
B1, B2, EPS = 0.9, 0.999, 1e-15


def _window_1d(dev, dt, size: int = 11, sigma: float = 1.5):
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2)).astype(np.float64)
    return torch.as_tensor((g / g.sum()).astype(np.float32), device=dev
                           ).to(dt)


def _blur(img, size: int = 11):
    c = img.shape[-1]
    g = _window_1d(img.device, img.dtype, size)
    x = img.permute(2, 0, 1)[None]
    pad = size // 2
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        x = F.conv2d(x, g.view(1, 1, -1, 1).expand(c, 1, -1, 1),
                     padding=(pad, 0), groups=c)
        x = F.conv2d(x, g.view(1, 1, 1, -1).expand(c, 1, 1, -1),
                     padding=(0, pad), groups=c)
    return x[0].permute(1, 2, 0)


def ssim(a, b):
    c = a.shape[-1]
    s = _blur(torch.cat([a, b, a * a, b * b, a * b], dim=-1))
    mu1, mu2 = s[..., :c], s[..., c:2 * c]
    m11, m22, m12 = s[..., 2 * c:3 * c], s[..., 3 * c:4 * c], s[..., 4 * c:]
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    num = (2 * mu1 * mu2 + c1) * (2 * (m12 - mu1 * mu2) + c2)
    den = ((mu1 * mu1 + mu2 * mu2 + c1)
           * ((m11 - mu1 * mu1) + (m22 - mu2 * mu2) + c2))
    return torch.mean(num / den)


def rays(view, dev, dt):
    """Per-pixel world ray directions [H,W,3] through integer pixel
    coordinates, image centre W/2."""
    W, H = view.width, view.height
    c2w = torch.as_tensor(view.c2w_rot, device=dev).to(dt)
    x = (torch.arange(W, device=dev, dtype=dt) - W / 2) / (
        W / (2 * view.tanfovx))
    y = (torch.arange(H, device=dev, dtype=dt) - H / 2) / (
        H / (2 * view.tanfovy))
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return xx[..., None] * c2w[:, 0] + yy[..., None] * c2w[:, 1] + c2w[:, 2]


def depth_to_normal(depth, ray, campos):
    pts = depth[..., None] * ray + campos[None, None, :]
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = torch.stack([dx[..., 1] * dy[..., 2] - dx[..., 2] * dy[..., 1],
                     dx[..., 2] * dy[..., 0] - dx[..., 0] * dy[..., 2],
                     dx[..., 0] * dy[..., 1] - dx[..., 1] * dy[..., 0]], -1)
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-24)
    return F.pad(n, (0, 0, 1, 1, 1, 1))


def geometry_loss(maps, view, target, mix, w2v, campos, keep=None):
    """The geometry loss over the blend's maps (colour with a black
    background, photometric + λ_dist·distortion + λ_normal·normal
    consistency). keep [H,W] bool, a fault's pixel mask: the means are
    taken over the kept pixels alone."""
    dt = maps["color"].dtype
    mean = (lambda x: x.mean()) if keep is None else (
        lambda x: x[keep].mean())
    image = maps["color"]
    alpha = 1.0 - maps["final_T"]
    lam = mix["lambda_dssim"]
    ll1 = mean(torch.abs(image - target))
    photo = (1.0 - lam) * ll1 + lam * (1.0 - ssim(image, target))
    Rm = w2v[:3, :3]
    n = maps["normal"]
    rend_normal = (n[..., 0:1] * Rm[0] + n[..., 1:2] * Rm[1]
                   + n[..., 2:3] * Rm[2])
    dr = mix["depth_ratio"]
    ok = alpha > 0
    depth = maps.get("depth")
    depth_exp = (torch.where(ok, depth / torch.where(ok, alpha, 1.0), 0.0)
                 if depth is not None else torch.zeros_like(alpha))
    med = torch.nan_to_num(maps["median_depth"], 0.0)
    surf = depth_exp * (1 - dr) + dr * med
    sn = depth_to_normal(surf[..., 0], rays(view, image.device, dt),
                         campos) * alpha.detach()
    normal_err = mean(1.0 - torch.sum(rend_normal * sn, dim=-1))
    total = photo + mix["lambda_normal"] * normal_err
    if mix["lambda_dist"]:
        total = total + mix["lambda_dist"] * mean(maps["distortion"][..., 0])
    return total


def adam(p, grads, m, v, count, lrs):
    """One Adam step over the fields of `grads` → (p, m, v) as new dicts."""
    count = count + 1
    dev = next(iter(grads.values())).device
    c1 = 1.0 - torch.tensor(B1, dtype=torch.float32, device=dev) ** float(
        count)
    c2 = 1.0 - torch.tensor(B2, dtype=torch.float32, device=dev) ** float(
        count)
    p, m, v = dict(p), dict(m), dict(v)
    for f, g in grads.items():
        m[f] = B1 * m[f] + (1 - B1) * g
        v[f] = B2 * v[f] + (1 - B2) * (g * g)
        p[f] = p[f] - lrs[f] * (m[f] / c1.to(g.dtype)) / (
            torch.sqrt(v[f] / c2.to(g.dtype)) + EPS)
    return p, m, v


def geometry_step(p, m, v, count, accum, view, target, mix, keep=None):
    """One geometry step from the raw fields p (dict) → (loss, grads, new
    p, m, v, accum): the render, the loss, autograd through the blend
    block by block, the densification statistics' gradient accumulation,
    Adam. keep: a fault's pixel mask (geometry_loss)."""
    dev, dt = p["xyz"].device, p["xyz"].dtype
    W, H = view.width, view.height
    t = lambda a: torch.as_tensor(a, device=dev).to(dt)
    w2v, fp, campos = t(view.w2v), t(view.full_proj), t(view.campos)
    leaves = {f: p[f].detach().requires_grad_(True) for f in GEOMETRY_FIELDS}
    a = R.activated(leaves)
    t0 = torch.zeros((p["xyz"].shape[0], 3, 3), device=dev, dtype=dt,
                     requires_grad=True)
    pre = R.preprocess(leaves["xyz"], a["scaling"], a["rotation"], w2v, fp,
                       campos, W, H, a["opacity"], shs=a["shs"])
    bins = R.bin_pairs(pre, W, H)
    flat = R.pack(pre.T + t0, pre.xy, pre.normal_view, a["opacity"],
                  pre.color)
    need_dist = bool(mix["lambda_dist"])
    maps, _ = R.blend_maps(flat, bins, W, H, need_dist)
    mkeys = ["color", "normal", "median_depth", "final_T"] + (
        ["depth", "distortion"] if need_dist else [])
    mleaf = {k: maps[k].detach().requires_grad_(True) for k in mkeys}
    loss = geometry_loss(mleaf, view, t(target), mix, w2v, campos, keep)
    gm = torch.autograd.grad(loss, [mleaf[k] for k in mkeys],
                             allow_unused=True)
    _, dflat = R.blend_maps(flat, bins, W, H, need_dist, grad_maps={
        k: g for k, g in zip(mkeys, gm) if g is not None})
    names = list(GEOMETRY_FIELDS)
    gs = torch.autograd.grad(flat, [leaves[f] for f in names] + [t0],
                             grad_outputs=dflat, allow_unused=True)
    grads = {f: (g if g is not None else torch.zeros_like(leaves[f]))
             for f, g in zip(names, gs[:-1])}
    tg = gs[-1] if gs[-1] is not None else torch.zeros_like(t0)
    with torch.no_grad():
        gx = tg[:, 0, 2] * pre.depth * 0.5 * W
        gy = tg[:, 1, 2] * pre.depth * 0.5 * H
        vis = (pre.valid & (pre.radius > 0)).to(dt)
        accum = accum + torch.linalg.norm(torch.stack([gx, gy], -1),
                                          dim=-1) * vis
        p2, m2, v2 = adam({f: p[f] for f in names}, grads, m, v, count,
                          mix["lrs"])
    return loss.detach(), grads, {**p, **p2}, m2, v2, accum


def contrastive_loss(features, labels, max_labels: int,
                     temp_lambda: float = 1000.0):
    """ProtoNCE over labelled features; label 0 is dropped, clusters live
    in [0, max_labels)."""
    dt = features.dtype
    labels = labels.to(torch.int64)
    ok = labels > 0
    labels = torch.clamp(labels - 1, 0, max_labels - 1)
    seg = torch.where(ok, labels, max_labels)
    feats = features / (torch.linalg.norm(features, dim=-1, keepdim=True)
                        + 1e-9).detach()
    featm = torch.where(ok[:, None], feats, 0.0)
    onehot = (seg[None, :] == torch.arange(
        max_labels, device=seg.device)[:, None]).to(dt)
    cnt = onehot @ ok.to(dt)
    present = cnt > 0
    cnt_safe = torch.clamp(cnt, min=1.0)
    u = (onehot @ featm) / cnt_safe[:, None]
    diff = torch.linalg.norm(feats - u[labels], dim=-1)
    phi = (onehot @ torch.where(ok, diff, 0.0)) / (
        cnt_safe * torch.log(cnt_safe + temp_lambda))
    phi = torch.clamp(phi * 10.0, 0.5, 1.0).detach()
    logits = (feats @ u.T) / phi[None, :]
    expd = torch.where(present[None, :], torch.exp(logits), 0.0)
    own = torch.gather(expd, 1, labels[:, None])[:, 0]
    log_p = torch.log(torch.clamp(own, min=1e-30) / (expd.sum(1) + 1e-9))
    return -torch.sum(torch.where(ok, log_p, 0.0))


def pixel_weights(geo: dict, view, pixels):
    """The blend weights of the frozen geometry at the flat pixel indices
    `pixels` [P] of `view`, as sparse rows: (row, gaussian, w) of every
    contribution, rows indexing `pixels`."""
    W, H = view.width, view.height
    gx = (W + R.TILE - 1) // R.TILE
    dev = pixels.device
    dt = geo["xyz"].dtype
    t = lambda a: torch.as_tensor(a, device=dev).to(dt)
    w2v, fp, campos = t(view.w2v), t(view.full_proj), t(view.campos)
    a = R.activated(geo)
    pre = R.preprocess(geo["xyz"], a["scaling"], a["rotation"], w2v, fp,
                       campos, W, H, a["opacity"],
                       color=torch.zeros_like(geo["xyz"]))
    bins = R.bin_pairs(pre, W, H)
    flat = R.pack(pre.T, pre.xy, pre.normal_view, a["opacity"], pre.color)
    y, x = pixels // W, pixels % W
    ptile = (y // R.TILE) * gx + x // R.TILE
    pin = (y % R.TILE) * R.TILE + x % R.TILE
    nt = gx * ((H + R.TILE - 1) // R.TILE)
    rows, cols, vals = [], [], []
    for tl, L in R.tile_blocks(bins, R.BLOCK):
        pos = torch.full((nt,), -1, dtype=torch.int64, device=dev)
        pos[torch.as_tensor(tl, device=dev)] = torch.arange(len(tl),
                                                            device=dev)
        sel = torch.nonzero(pos[ptile] >= 0)[:, 0]
        if sel.numel() == 0:
            continue
        o = R.blend_block(flat, bins, tl, L, gx, need_dist=False)
        b = pos[ptile[sel]]
        w = o["w"][b, pin[sel]]                               # [S, L]
        g = o["gid"][b]
        nz = torch.nonzero(w != 0)
        rows.append(sel[nz[:, 0]])
        cols.append(g[nz[:, 0], nz[:, 1]])
        vals.append(w[nz[:, 0], nz[:, 1]])
        del o
    if not rows:
        e = torch.zeros(0, dtype=torch.int64, device=dev)
        return e, e.clone(), torch.zeros(0, device=dev, dtype=dt)
    return torch.cat(rows), torch.cat(cols), torch.cat(vals)


def features_at(fn, weights, n_rows: int):
    """Σ_g w · fn[g] per row of sparse weights (row, gaussian, w)."""
    rows, cols, vals = weights
    out = fn.new_zeros((n_rows, fn.shape[1]))
    return out.index_add(0, rows, fn[cols] * vals.to(fn.dtype)[:, None])


def semantic_step(geo, segf, m, v, count, views, step, mix, keep=None):
    """One semantic step → (loss, grad, segf, m, v). views: the training
    views; step: {"cam": i, "sv": pixel indices, "d3": gaussian indices,
    "mv": (first view, indices over the window's concatenated frames) or
    None, "segmap": [H·W] labels per view (list), "lab3d"}. keep: a fault's
    mask over the drawn pixels (the loss then reads the kept ones)."""
    seg = segf.detach().requires_grad_(True)
    fn = R.normed(seg)
    lab = step["segmaps"]
    mx = mix["max_labels"]
    sv = step["sv"]
    if keep is not None:
        sv = sv[keep]
    wts = pixel_weights(geo, views[step["cam"]], sv)
    f_sv = features_at(fn, wts, sv.shape[0])
    loss = contrastive_loss(f_sv, lab[step["cam"]][sv], mx) * (
        mix["lam_sv"] * 0.5 * step["sv"].shape[0] / sv.shape[0])
    d3 = step["d3"]
    f3 = seg[d3]
    f3 = f3 / (torch.linalg.norm(f3, dim=1, keepdim=True) + 1e-6)
    loss = loss + contrastive_loss(f3, step["lab3d"][d3], mx) * mix["lam_3d"]
    if step["mv"] is not None:
        v0, idx = step["mv"]
        hw = views[0].width * views[0].height
        view_of = idx // hw
        f_mv = fn.new_zeros((idx.shape[0], fn.shape[1]))
        labels = torch.zeros_like(idx)
        for k in range(mix["n_mv"]):
            sel = torch.nonzero(view_of == k)[:, 0]
            px = idx[sel] % hw
            wk = pixel_weights(geo, views[v0 + k], px)
            f_mv = f_mv.index_copy(0, sel, features_at(fn, wk, px.shape[0]))
            labels[sel] = lab[v0 + k][px].to(labels.dtype)
        loss = loss + contrastive_loss(f_mv, labels, mx) * mix["lam_mv"]
    (g,) = torch.autograd.grad(loss, [seg])
    with torch.no_grad():
        p2, m2, v2 = adam({"seg_feature": segf}, {"seg_feature": g},
                          {"seg_feature": m}, {"seg_feature": v}, count,
                          {"seg_feature": mix["lr_seg_feature"]})
    return (loss.detach(), g, p2["seg_feature"], m2["seg_feature"],
            v2["seg_feature"])
