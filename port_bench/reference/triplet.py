"""Plain reference of the triplet pretraining step: the train augmentation
of each view, one train-mode forward over [anchor; positive; extra], the
online triplet loss with ``random_semi_hard`` mining plus the local-local
contrast, backward, and SGD with momentum.

The random draws are the program's protocol, taken from the same seeds:
one generator on the device, reseeded for each step from
``step_seed(epoch, step)``, gives the augmentation draws of each view in
turn (``draw_params``) and then the (N, N, N) Gumbel draws of the miner.
Equal calls on an equally seeded generator give equal numbers, so the
reference sees the draws the program saw without taking any from it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from . import models

BASE_SEED = 1234
MEAN_STD = {
    "kinetics": ((0.4345, 0.4051, 0.3775), (0.2768, 0.2713, 0.2737)),
    "imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}
GRAY = (0.299, 0.587, 0.114)
NEG_INF = -1e30
F32_TINY = 1.1754943508222875e-38
F32_EPS = 1.1920928955078125e-07


def step_seed(epoch: int, step: int) -> int:
    """The generator's seed of a step (the JAX driver's fold of
    ``epoch * 100000 + batch_idx`` into its base key 1234)."""
    return BASE_SEED * 1_000_003 + epoch * 100000 + step


# --------------------------------------------------------------------------
# augmentation

def _u(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def draw_params(g: torch.Generator, b: int, crop_hw=None) -> dict:
    """One view's draws, in the program's order: with ``crop_hw`` ten
    RandomResizedCrop attempts (area scale in [0.25, 1], log ratio in
    [log 3/4, log 4/3]) and a placement; then flip, the four jitter
    factors (brightness, contrast, saturation in [0.5, 1.5], hue in
    [-0.5, 0.5]), the jitter order, and the jitter, gray and blur coins."""
    p = {}
    if crop_hw is not None:
        p["area"] = _u(g, (b, 10), 0.25, 1.0)
        p["log_ratio"] = _u(g, (b, 10), math.log(0.75), math.log(1 / 0.75))
        p["place"] = _u(g, (b, 2), 0.0, 1.0)
    p["flip"] = _u(g, (b,), 0.0, 1.0) < 0.5
    p["factors"] = torch.cat([_u(g, (b, 3), 0.5, 1.5),
                              _u(g, (b, 1), -0.5, 0.5)], dim=1)
    p["order"] = torch.argsort(_u(g, (b, 4), 0.0, 1.0), dim=1)
    p["jitter"] = _u(g, (b,), 0.0, 1.0) < 0.8
    p["gray"] = _u(g, (b,), 0.0, 1.0) < 0.2
    p["blur"] = _u(g, (b,), 0.0, 1.0) < 0.2
    return p


def crop_box(area, log_ratio, place, h: int, w: int):
    """torchvision's RandomResizedCrop choice for one clip: the first of
    the ten attempts that fits, else the whole frame -> (top, left, height,
    width)."""
    target = (h * w) * area
    aspect = torch.exp(log_ratio)
    ws, hs = torch.sqrt(target * aspect), torch.sqrt(target / aspect)
    for i in range(area.shape[0]):
        if ws[i] <= w and hs[i] <= h:
            ch, cw = hs[i], ws[i]
            break
    else:
        ch = torch.tensor(float(h), device=area.device)
        cw = torch.tensor(float(w), device=area.device)
    return place[0] * (h - ch), place[1] * (w - cw), ch, cw


def resample_matrix(n_in: int, n_out: int, start, length) -> torch.Tensor:
    """(n_in, n_out) weights of an antialiased linear resample of the
    window [start, start + length) of n_in samples onto n_out (the
    semantics of ``jax.image.scale_and_translate``, bilinear): output o
    samples input position (o + 0.5) length / n_out + start - 0.5 under a
    triangle kernel widened by length / n_out when that exceeds 1; weights
    are normalised to sum to 1, and an output whose position lies outside
    [-0.5, n_in - 0.5] gets none."""
    dev = length.device
    scale = n_out / length
    inv = 1.0 / scale
    width = torch.clamp_min(inv, 1.0)
    o = torch.arange(n_out, dtype=torch.float32, device=dev)
    pos = (o + 0.5) * inv - (-start * scale) * inv - 0.5
    i = torch.arange(n_in, dtype=torch.float32, device=dev)
    wts = torch.clamp_min(1.0 - (pos[None, :] - i[:, None]).abs() / width,
                          0.0)
    tot = wts.sum(0, keepdim=True)
    wts = torch.where(tot.abs() > 1000 * F32_EPS,
                      wts / torch.where(tot != 0, tot, torch.ones_like(tot)),
                      torch.zeros_like(wts))
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return torch.where(inside[None, :], wts, torch.zeros_like(wts))


def gray(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] * GRAY[0] + x[..., 1] * GRAY[1] + x[..., 2] * GRAY[2]


def rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    s = torch.where(mx > 0, d / torch.clamp_min(mx, 1e-8), 0.0)
    dd = torch.clamp_min(d, 1e-8)
    rc, gc, bc = (mx - r) / dd, (mx - g) / dd, (mx - b) / dd
    h = torch.where(r == mx, bc - gc,
                    torch.where(g == mx, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    return torch.where(d == 0, 0.0, h), s, mx


def hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int64), 6)
    table = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = []
    for c in range(3):
        ch = torch.zeros_like(v)
        for k in range(6):
            ch = torch.where(i == k, table[k][c], ch)
        out.append(ch)
    return torch.stack(out, -1)


def jitter_op(x, k: int, f):
    if k == 0:  # brightness
        return (x * f).clamp(0, 1)
    if k == 1:  # contrast: against the mean gray of the whole clip
        m = gray(x).mean()
        return (m + f * (x - m)).clamp(0, 1)
    if k == 2:  # saturation
        g = gray(x)[..., None]
        return (g + f * (x - g)).clamp(0, 1)
    h, s, v = rgb_to_hsv(x)
    return hsv_to_rgb(torch.remainder(h + f, 1.0), s, v).clamp(0, 1)


def blur(x: torch.Tensor) -> torch.Tensor:
    """15 x 15 Gaussian of sigma 2 on every frame and channel, zero
    padded: (T, H, W, C)."""
    k = torch.arange(15, dtype=torch.float32, device=x.device) - 7.0
    k = torch.exp(-k ** 2 / 8.0)
    k = k / k.sum()
    t, h, w, c = x.shape
    y = x.permute(0, 3, 1, 2).reshape(t * c, 1, h, w)
    y = F.conv2d(y, k.view(1, 1, 15, 1), padding=(7, 0))
    y = F.conv2d(y, k.view(1, 1, 1, 15), padding=(0, 7))
    return y.reshape(t, c, h, w).permute(0, 2, 3, 1)


def augment(clips_u8: torch.Tensor, p: dict, size: int,
            dataset: str) -> torch.Tensor:
    """uint8 (B, T, H, W, 3) -> normalised float32 (B, T, S, S, 3), one
    clip at a time."""
    mean, std = MEAN_STD["kinetics" if dataset == "kinetics" else "imagenet"]
    mean = torch.tensor(mean, device=clips_u8.device)
    std = torch.tensor(std, device=clips_u8.device)
    out = []
    for i in range(clips_u8.shape[0]):
        x = clips_u8[i].float() / 255.0
        if "area" in p:
            _, h, w, _ = x.shape
            top, left, ch, cw = crop_box(p["area"][i], p["log_ratio"][i],
                                         p["place"][i], h, w)
            wy = resample_matrix(h, size, top, ch)
            wx = resample_matrix(w, size, left, cw)
            x = torch.einsum("thwc,hy,wx->tyxc", x, wy, wx)
        if p["flip"][i]:
            x = x.flip(2)
        if p["jitter"][i]:
            for k in p["order"][i].tolist():
                x = jitter_op(x, k, p["factors"][i, k])
        if p["gray"][i]:
            x = gray(x)[..., None].expand_as(x)
        if p["blur"][i]:
            x = blur(x)
        out.append((x - mean) / std)
    return torch.stack(out)


# --------------------------------------------------------------------------
# loss

def cosine_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    an = a / a.norm(dim=1, keepdim=True).clamp_min(1e-12)
    bn = b / b.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return 1.0 - an @ bn.T


def triplet_loss(emb: torch.Tensor, labels: torch.Tensor, margin: float,
                 g: torch.Generator, picks: Optional[torch.Tensor] = None):
    """Online triplet loss, ``random_semi_hard``: every pair i < j of one
    label (with some other label in the batch) takes a negative uniformly
    among the semi-hard ones (d_ap + margin > d_an; Gumbel-max over the
    generator's (N, N, N) draws), else the anchor's nearest negative; the
    mean of relu(d_ap + margin - d_an) over the pairs.

    ``picks``: another run's negatives (N, N), which the loss then takes.
    Each is judged against this run's own pick: where they differ, the
    distance from the semi-hard boundary (d_ap + margin - d_an = 0), in this
    run's distances, of the nearer of the two (the other run saw that one
    on the other side of the boundary), or how near the two are to a tie
    when this run had no semi-hard negative; a pick that is no negative of
    the anchor, or picks of another batch's shape, are infinitely far. -> (loss, own picks, the largest gap)."""
    n = emb.shape[0]
    d = cosine_dist(emb, emb)
    same = labels[:, None] == labels[None, :]
    neg = ~same
    pairs = same & torch.ones_like(same).triu(1) & neg.any(1)[:, None]
    pl = d[:, :, None] + margin - d[:, None, :]
    semi = neg[:, None, :] & (pl > 0)
    u = torch.rand((n, n, n), generator=g, device=g.device)
    gum = -torch.log(-torch.log(u.clamp_min(F32_TINY)))
    logits = torch.where(semi, 0.0, NEG_INF) + gum
    own = logits.argmax(-1)
    ok = logits.gather(-1, own[..., None])[..., 0] > NEG_INF / 2
    easy = torch.where(neg, d, float("inf")).argmin(-1)[:, None]
    own = torch.where(ok, own, easy.expand_as(own))
    gap = torch.zeros((), device=emb.device)
    use = own
    if picks is not None and picks.shape != own.shape:
        gap = torch.tensor(float("inf"))  # picks of another batch
    elif picks is not None:
        use = picks.to(own.device)
        differ = pairs & (use != own)
        at = lambda t, i: t.gather(-1, i[..., None])[..., 0]  # noqa: E731
        near = torch.minimum(at(pl, use).abs(), at(pl, own).abs())
        tie = (d.gather(1, use) - d.gather(1, own)).abs()
        each = torch.where(ok, near, tie)
        each = torch.where(neg.gather(1, use), each, float("inf"))
        gap = torch.where(differ, each, 0.0).max()
    per = F.relu(d + margin - d.gather(1, use))
    loss = torch.where(pairs, per, 0.0).sum() / pairs.sum().clamp_min(1)
    return loss, own, gap


def local_local(anc, pos, anc2, margin: float) -> torch.Tensor:
    """A second clip of the anchor video closer than the positive:
    mean relu(d(anc, anc2) - d(anc, pos) + margin), row-wise cosine."""
    def rowd(a, b):
        a = a / a.norm(dim=1, keepdim=True).clamp_min(1e-12)
        b = b / b.norm(dim=1, keepdim=True).clamp_min(1e-12)
        return 1.0 - (a * b).sum(1)
    return F.relu(rowd(anc, anc2) - rowd(anc, pos) + margin).mean()


# --------------------------------------------------------------------------
# the steps

def run_steps(arch: str, state: Dict[str, torch.Tensor],
              batches: List[Dict[str, torch.Tensor]], seeds: List[int],
              spec: dict, device: torch.device, quant=None,
              picks: Optional[list] = None) -> dict:
    """Steps of the reference from ``state`` over ``batches`` (uint8
    views on ``device`` and ``targets``), each step's generator seeded from
    ``seeds``. ``spec``: views, size, crop (bool), dataset, margin,
    llc_weight, llc_margin (None: no local-local term), lr, momentum,
    alpha. ``picks``: the judged run's negatives of each step, which the
    losses take (``triplet_loss``). -> losses, each step's gradient norm
    per parameter, the first gradient's, the norm of each parameter's
    change after the steps, this run's own picks, the first step's
    judged picks' largest gap (later steps start from other weights) and
    the first step's embeddings."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = models.build(arch).to(device)
    model.load_state_dict(state)
    model.train()
    model.set_quant(quant)
    params = dict(model.named_parameters())
    start = {k: v.detach().clone() for k, v in params.items()}
    bufs: Dict[str, torch.Tensor] = {}
    losses, grads, own, gaps = [], [], [], []
    g = torch.Generator(device=device)
    for i, (batch, seed) in enumerate(zip(batches, seeds)):
        g.manual_seed(seed)
        views = []
        for v in spec["views"]:
            x = batch[v]
            crop = tuple(x.shape[2:4]) if spec["crop"] else None
            views.append(augment(x, draw_params(g, x.shape[0], crop),
                                 spec["size"], spec["dataset"]))
        clips = torch.cat(views)
        x = (models.slow_fast_input(clips, spec["alpha"])
             if arch == "slowfast50" else clips)
        emb = model(x).float()
        b = views[0].shape[0]
        labels = batch["targets"]
        loss, mine, gap = triplet_loss(emb[:2 * b], labels, spec["margin"],
                                       g, None if picks is None else picks[i])
        own.append(mine.cpu())
        gaps.append(float(gap.detach()))
        if i == 0:
            emb1 = emb.detach().cpu()
        if spec.get("llc_margin") is not None:
            loss = loss + spec["llc_weight"] * local_local(
                emb[:b], emb[b:2 * b], emb[2 * b:], spec["llc_margin"])
        model.zero_grad(set_to_none=True)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({k: float(p.grad.norm()) for k, p in params.items()})
        with torch.no_grad():
            for k, p in params.items():
                if k in bufs:
                    bufs[k].mul_(spec["momentum"]).add_(p.grad)
                else:
                    bufs[k] = p.grad.clone()
                p.sub_(spec["lr"] * bufs[k])
    change = {k: float((p.detach() - start[k]).norm())
              for k, p in params.items()}
    return {"loss": losses, "grads": grads, "grad1": grads[0],
            "change": change, "picks": own, "pick_gap": gaps[0],
            "emb1": emb1}
