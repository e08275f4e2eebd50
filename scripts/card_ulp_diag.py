"""Where the CUDA card and the CPU part on the measured BRDF and on hair.

    python3 scripts/card_ulp_diag.py [--device cuda]

tests/test_torch_cuda.py's item1 tests and chip_smoke.py's phase 30 (f)
hold measured_f, measured_pdf, measured_sample, hair_f, hair_pdf and
hair_sample on the card to the CPU.  On those tests' own inputs this
prints, for each function:

- the share of lanes close at rtol 1e-5, 1e-4, 1e-3 and 1e-2 (atol 1e-6;
  sampled directions at atol 1e-5), as the port runs;
- the same shares with the card's transcendental functions (arccos, atan2,
  arcsin, sin, cos, exp, log) taken from the CPU on the card's own
  arguments: what still differs is arithmetic, not those functions;
- per transcendental, the share of its arguments on which the card's
  float32 result differs from the CPU's, and the largest difference in
  ulps;
- for measured_sample, the share of the lanes whose direction differs on
  which either warp (luminance, vndf) put the sample in another row of
  its table (the 2D warp is continuous along a row, not across rows), and
  the card's f and pdf against the CPU's measured_f / measured_pdf at the
  card's own sampled direction, beside the CPU's own sample against its
  own evaluation.

With --device cpu it runs the CPU against itself (a dry run on a machine
without a card).
"""
import argparse
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from acceleratedvolrenderer_tpu_torch.models import hair, measured  # noqa

TRANSCENDENTALS = ("arccos", "atan2", "arcsin", "sin", "cos", "exp", "log")
RTOLS = (1e-5, 1e-4, 1e-3, 1e-2)


def ulps(a, b):
    """|a - b| in float32 ulps (ordered integer distance)."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


class HostMath:
    """Stands in for `torch` in a module: the functions in TRANSCENDENTALS
    run on the device and on the CPU; `host` picks which result is
    returned.  Each call's ulp differences are kept in `stats`."""

    def __init__(self, host):
        self.host, self.stats = host, {}

    def __getattr__(self, name):
        fn = getattr(torch, name)
        if name not in TRANSCENDENTALS:
            return fn

        def both(*args, **kw):
            out = fn(*args, **kw)
            ref = fn(*(a.cpu() if torch.is_tensor(a) else a for a in args),
                     **kw)
            d = ulps(out.detach().cpu().numpy(), ref.numpy()).ravel()
            fin = np.isfinite(ref.numpy()).ravel()
            n, k, m = self.stats.get(name, (0, 0, 0))
            self.stats[name] = (n + int(fin.sum()),
                                k + int((d[fin] > 0).sum()),
                                max(m, int(d[fin].max(initial=0))))
            return ref.to(out.device) if self.host else out
        return both


def shares(got, want, atol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    out = []
    for rt in RTOLS:
        ok = np.isclose(got, want, rtol=rt, atol=atol)
        out.append(float(ok.reshape(len(ok), -1).all(-1).mean()))
    return out


def fmt(s):
    return " / ".join(f"{x:.5f}" for x in s)


def measured_inputs():
    """test_item1_measured_matches_cpu's inputs."""
    rng = np.random.default_rng(2)
    n = 16384
    dirs = lambda: (lambda v: v / np.linalg.norm(v, axis=1, keepdims=True))(
        rng.normal(size=(n, 3))).astype(np.float32)
    return dict(wo=dirs(), wi=dirs(), u=rng.random((n, 2)).astype(np.float32),
                lam=rng.uniform(380, 720, (n, 4)).astype(np.float32))


def run_measured(dev, host):
    """measured_f, measured_pdf and measured_sample on dev; the warps'
    sampled points kept for the row check."""
    brdf = measured.synthesize_ggx(alpha=0.3, res=32, n_theta=8)
    pts = {}
    for name in ("luminance", "vndf"):
        warp = getattr(brdf, name)

        def keep(u2, pvals=(), _w=warp, _s=warp.sample, _n=name):
            p, pdf = _s(u2, pvals)
            y = torch.clamp((p[..., 1] * (_w.ny - 1)).to(torch.int64), 0,
                            _w.ny - 2)
            pts[_n] = y.cpu().numpy()
            return p, pdf
        warp.sample = keep
    a = {k: torch.as_tensor(v, device=dev)
         for k, v in measured_inputs().items()}
    hm = HostMath(host)
    with mock.patch.object(measured, "torch", hm):
        out = dict(
            f=measured.measured_f(brdf, a["wo"], a["wi"], a["lam"]),
            pdf=measured.measured_pdf(brdf, a["wo"], a["wi"]),
            sample=measured.measured_sample(brdf, a["wo"], a["u"], a["lam"]))
    out = {k: ([x.cpu().numpy() for x in v] if isinstance(v, tuple)
               else v.cpu().numpy()) for k, v in out.items()}
    return brdf, a, out, pts, hm.stats


def hair_inputs(which):
    """test_item1_hair_matches_cpu's inputs ("test") or chip_smoke phase 30
    (f)'s first 65,536 lanes ("smoke")."""
    if which == "test":
        rng = np.random.default_rng(3)
        n = 16384
        unit = lambda v: (v / np.linalg.norm(v, axis=1, keepdims=True))
        return dict(wo=unit(rng.normal(size=(n, 3))),
                    wi=unit(rng.normal(size=(n, 3))),
                    h=rng.uniform(-1, 1, n), sa=rng.uniform(0, 2, (n, 3)),
                    u=rng.random((n, 4))), hair.HairParams(beta_m=0.3,
                                                           beta_n=0.3)
    rng = np.random.default_rng(31)
    n = 1 << 20
    v = rng.normal(size=(n, 3))
    host = dict(wo=v / np.linalg.norm(v, axis=1, keepdims=True),
                h=rng.uniform(-1, 1, n), u=rng.random((n, 4)))
    m = 65536
    host = {k: x[:m] for k, x in host.items()}
    host["sa"] = np.zeros((m, 3))
    return host, hair.HairParams(beta_m=0.4, beta_n=0.4)


def run_hair(which, dev, host):
    arrays, prm = hair_inputs(which)
    a = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
         for k, v in arrays.items()}
    hm = HostMath(host)
    with mock.patch.object(hair, "torch", hm):
        out = dict(sample=hair.hair_sample(a["wo"], a["h"], a["sa"], prm,
                                           a["u"]))
        if "wi" in a:
            out["f"] = hair.hair_f(a["wo"], a["wi"], a["h"], a["sa"], prm)
            out["pdf"] = hair.hair_pdf(a["wo"], a["wi"], a["h"], a["sa"],
                                       prm)
    out = {k: ([x.cpu().numpy() for x in v] if isinstance(v, tuple)
               else v.cpu().numpy()) for k, v in out.items()}
    return a, prm, out, hm.stats


def print_stats(what, stats):
    for name, (n, k, m) in sorted(stats.items()):
        print(f"  {what}: torch.{name} differs on {k} of {n} arguments "
              f"({k / max(n, 1):.4f}), at most {m} ulp", flush=True)


def measured_report(dev):
    cpu = torch.device("cpu")
    _, _, ref, ref_pts, _ = run_measured(cpu, False)
    brdf, a, got, pts, stats = run_measured(dev, False)
    _, _, hgot, _, _ = run_measured(dev, True)
    print("measured (res 32, n_theta 8; 16,384 lanes; shares at rtol "
          f"{' / '.join(map(str, RTOLS))})", flush=True)
    print_stats("measured", stats)
    for k in ("f", "pdf"):
        print(f"  measured_{k}: card vs CPU {fmt(shares(got[k], ref[k]))}; "
              f"with the CPU's transcendentals "
              f"{fmt(shares(hgot[k], ref[k]))}", flush=True)
    wi, f, pdf, valid = got["sample"]
    cwi, cf, cpdf, cvalid = ref["sample"]
    hwi = hgot["sample"][0]
    near = lambda x: (np.isclose(x, cwi, rtol=0, atol=1e-5).all(-1)
                      & (valid == cvalid))
    ok, hok = near(wi), near(hwi)
    off = ~ok
    flip = (pts["luminance"] != ref_pts["luminance"]) | (
        pts["vndf"] != ref_pts["vndf"])
    print(f"  measured_sample directions (atol 1e-5): card vs CPU "
          f"{ok.mean():.5f}, with the CPU's transcendentals {hok.mean():.5f};"
          f" of the {int(off.sum())} lanes apart, {int((off & flip).sum())} "
          f"sampled another table row, largest |dwi| "
          f"{np.abs(wi - cwi)[off].max(initial=0):.3e}", flush=True)
    # the card's sample against the CPU's evaluation at the same direction
    on = torch.as_tensor(wi)
    wo, lam = a["wo"].cpu(), a["lam"].cpu()
    ef = measured.measured_f(brdf, wo, on, lam).numpy()
    ep = measured.measured_pdf(brdf, wo, on).numpy()
    cef = measured.measured_f(brdf, wo, torch.as_tensor(cwi), lam).numpy()
    cep = measured.measured_pdf(brdf, wo, torch.as_tensor(cwi)).numpy()
    print(f"  card sample vs CPU evaluation at the card's direction, "
          f"{int(valid.sum())} valid lanes: f "
          f"{fmt(shares(f[valid], ef[valid]))}, pdf "
          f"{fmt(shares(pdf[valid], ep[valid]))}; the CPU's sample vs "
          f"its own evaluation: f {fmt(shares(cf[cvalid], cef[cvalid]))}, pdf "
          f"{fmt(shares(cpdf[cvalid], cep[cvalid]))}", flush=True)


def hair_report(which, dev):
    cpu = torch.device("cpu")
    _, _, ref, _ = run_hair(which, cpu, False)
    a, prm, got, stats = run_hair(which, dev, False)
    _, _, hgot, _ = run_hair(which, dev, True)
    n = a["wo"].shape[0]
    beta = 0.3 if which == "test" else 0.4
    print(f"hair ({which}: {n} lanes, beta_m = beta_n = {beta})", flush=True)
    print_stats(f"hair {which}", stats)
    for k in ("f", "pdf"):
        if k in got:
            print(f"  hair_{k}: card vs CPU {fmt(shares(got[k], ref[k]))}; "
                  f"with the CPU's transcendentals "
                  f"{fmt(shares(hgot[k], ref[k]))}", flush=True)
    cat = lambda t: np.concatenate([x.reshape(n, -1) for x in t], -1)
    print(f"  hair_sample (wi, f, pdf): card vs CPU "
          f"{fmt(shares(cat(got['sample']), cat(ref['sample'])))}; with the "
          f"CPU's transcendentals "
          f"{fmt(shares(cat(hgot['sample']), cat(ref['sample'])))}",
          flush=True)
    # the card's sample against the CPU's hair_f / hair_pdf at the card's
    # own direction
    wi, f, pdf = got["sample"]
    c = {k: v.cpu() for k, v in a.items()}
    ef = hair.hair_f(c["wo"], torch.as_tensor(wi), c["h"], c["sa"],
                     prm).numpy()
    ep = hair.hair_pdf(c["wo"], torch.as_tensor(wi), c["h"], c["sa"],
                       prm).numpy()
    print(f"  card sample vs CPU evaluation at the card's direction: f "
          f"{fmt(shares(f, ef))}, pdf {fmt(shares(pdf, ep))}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("card_ulp_diag: CUDA is not available", file=sys.stderr)
        return 1
    measured_report(dev)
    hair_report("test", dev)
    hair_report("smoke", dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
