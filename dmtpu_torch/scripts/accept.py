"""One-command acceptance runner for the BASELINE.md quality tables.

    python -m dmtpu_torch.scripts.accept --group ddpm --weights ckpt.pt \\
        --inception_weights pt_inception-2015-12-05-52768-1.pth --cifar10_dir DATA \\
        [--rows ddim_10,...] [key=value ...] [--device cuda|cpu]

    python -m dmtpu_torch.scripts.accept --self_test   # the machinery, no artifact

Counterpart of ``scripts/accept.py``.  The reference publishes FID / IS on
50K CIFAR-10 samples (reference: docs/DDPM.md "Evaluation",
docs/Samplers.md, docs/DDPM-IP.md, docs/Classifier-Free Guidance.md;
mirrored in BASELINE.md).  For each selected row it samples ``--n_samples``
images with the row's sampler, converts them to uint8 by truncation, takes
their pool3 features and 1008-way probabilities through the FID InceptionV3
on the card, computes FID (against the CIFAR-10 train split) and IS on the
host in float64, and diffs them against the published numbers within
``--fid_tol_*`` / ``--is_tol_rel``.  Exit codes: 0 every row in tolerance, 1
a row out, 2 missing artifacts (each one named) or no card.

The row tables, the tolerance machinery, the flags and the exit codes are
the JAX script's; the port adds ``--device`` (default ``cuda``) and takes the
config's ``key=value`` overrides as its other CLIs do: on the card the
attention kernel takes bf16, so an f32 config runs with
``model.params.dtype=bfloat16``.  The checkpoint is an upstream torch file in
the model's keys, a ``train_ddpm`` ``state.pt`` (its EMA) or a JAX-package
``.npz`` export (``_common.load_model_params``).  Noise: the JAX script folds
the batch index into its key; here each batch draws its noise and then its
sampler's steps from one generator on the device seeded from (seed, batch
index) (``sample_uncond.fold_generator``), so the draws differ from the JAX
package's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from dmtpu_torch.data.datasets import CIFAR10
from dmtpu_torch.diffusions import DDIM, DDIMCFG, DDPM, EulerSampler, HeunSampler
from dmtpu_torch.eval import InceptionFeatureExtractor
from dmtpu_torch.eval.fid import fid_from_features, frechet_distance, inception_score
from dmtpu_torch.scripts._common import image_shape, load_conf, load_model_params
from dmtpu_torch.scripts.sample_sd import resolve_device
from dmtpu_torch.scripts.sample_uncond import fold_generator
from dmtpu_torch.utils.config import instantiate_from_config
from dmtpu_torch.utils.logger import get_logger
from dmtpu_torch.utils.misc import amortize

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# ---------------------------------------------------------------------------
# BASELINE.md rows.  Key -> sampler config + published FID / IS(mean).
# "group" names the checkpoint the row needs (one trained model per group;
# the DDPM table's pred_x0/pred_v rows are separate checkpoints -> separate
# groups, matching how the reference trained them).
# ---------------------------------------------------------------------------


def _r(group, sampler, steps, fid, is_mean, **kw):
    return dict(group=group, sampler=sampler, steps=steps,
                fid=fid, is_mean=is_mean, **kw)


ROWS = {
    # docs/DDPM.md — pred_eps checkpoint, DDPM sampler, both var types
    "ddpm_large_1000": _r("ddpm", "ddpm", 1000, 3.0459, 9.4515, var_type="fixed_large"),
    "ddpm_large_100": _r("ddpm", "ddpm", 100, 46.5454, 8.7223, var_type="fixed_large"),
    "ddpm_large_50": _r("ddpm", "ddpm", 50, 85.2221, 6.3863, var_type="fixed_large"),
    "ddpm_large_20": _r("ddpm", "ddpm", 20, 183.3468, 2.6885, var_type="fixed_large"),
    "ddpm_large_10": _r("ddpm", "ddpm", 10, 266.7540, 1.5870, var_type="fixed_large"),
    "ddpm_small_1000": _r("ddpm", "ddpm", 1000, 5.3727, 9.0118, var_type="fixed_small"),
    "ddpm_small_100": _r("ddpm", "ddpm", 100, 11.2191, 8.6237, var_type="fixed_small"),
    "ddpm_small_50": _r("ddpm", "ddpm", 50, 15.0471, 8.4077, var_type="fixed_small"),
    "ddpm_small_20": _r("ddpm", "ddpm", 20, 24.5131, 7.9957, var_type="fixed_small"),
    "ddpm_small_10": _r("ddpm", "ddpm", 10, 41.0479, 7.1373, var_type="fixed_small"),
    # pred_x0 / pred_v checkpoints (their own groups)
    "ddpm_x0_large_1000": _r("ddpm_pred_x0", "ddpm", 1000, 13.3310, 7.7624,
                             var_type="fixed_large"),
    "ddpm_x0_small_1000": _r("ddpm_pred_x0", "ddpm", 1000, 14.3750, 7.7426,
                             var_type="fixed_small"),
    "ddpm_v_large_1000": _r("ddpm_pred_v", "ddpm", 1000, 3.9703, 9.0253,
                            var_type="fixed_large"),
    "ddpm_v_small_1000": _r("ddpm_pred_v", "ddpm", 1000, 6.6707, 8.6282,
                            var_type="fixed_small"),
    # docs/Samplers.md — same pred_eps checkpoint, other samplers
    "ddim_1000": _r("ddpm", "ddim", 1000, 4.1892, 9.0626, eta=0.0),
    "ddim_100": _r("ddpm", "ddim", 100, 6.0508, 8.8424, eta=0.0),
    "ddim_50": _r("ddpm", "ddim", 50, 7.7011, 8.7076, eta=0.0),
    "ddim_20": _r("ddpm", "ddim", 20, 11.6506, 8.4744, eta=0.0),
    "ddim_10": _r("ddpm", "ddim", 10, 18.9559, 8.0852, eta=0.0),
    "euler_1000": _r("ddpm", "euler", 1000, 4.2099, 9.0678),
    "euler_100": _r("ddpm", "euler", 100, 6.0469, 8.8511),
    "euler_50": _r("ddpm", "euler", 50, 7.6770, 8.7217),
    "euler_20": _r("ddpm", "euler", 20, 11.6681, 8.4362),
    "euler_10": _r("ddpm", "euler", 10, 18.7698, 8.0287),
    "heun_500": _r("ddpm", "heun", 500, 4.0046, 9.0509),
    "heun_50": _r("ddpm", "heun", 50, 3.4687, 9.2595),
    "heun_25": _r("ddpm", "heun", 25, 5.8767, 9.4325),
    "heun_10": _r("ddpm", "heun", 10, 29.6088, 8.4687),
    "heun_5": _r("ddpm", "heun", 5, 82.0586, 5.3521),
    # docs/DDPM-IP.md — input-perturbation checkpoint, DDPM sampler
    "ip_large_1000": _r("ddpm_ip", "ddpm", 1000, 3.2497, 9.4885, var_type="fixed_large"),
    "ip_large_100": _r("ddpm_ip", "ddpm", 100, 46.7994, 8.5720, var_type="fixed_large"),
    "ip_large_50": _r("ddpm_ip", "ddpm", 50, 87.1883, 6.1429, var_type="fixed_large"),
    "ip_large_10": _r("ddpm_ip", "ddpm", 10, 268.1108, 1.5842, var_type="fixed_large"),
    "ip_small_1000": _r("ddpm_ip", "ddpm", 1000, 4.4868, 9.1092, var_type="fixed_small"),
    "ip_small_100": _r("ddpm_ip", "ddpm", 100, 9.2460, 8.7068, var_type="fixed_small"),
    "ip_small_50": _r("ddpm_ip", "ddpm", 50, 12.7965, 8.4902, var_type="fixed_small"),
    "ip_small_10": _r("ddpm_ip", "ddpm", 10, 35.5062, 7.3680, var_type="fixed_small"),
    # docs/Classifier-Free Guidance.md — conditional checkpoint, DDIM-50
    "cfg_s0": _r("cfg", "ddim_cfg", 50, 6.2904, 8.9851, guidance_scale=0.0),
    "cfg_s1": _r("cfg", "ddim_cfg", 50, 4.6630, 9.1763, guidance_scale=1.0),
    "cfg_s3": _r("cfg", "ddim_cfg", 50, 10.2304, 9.6252, guidance_scale=3.0),
    "cfg_s5": _r("cfg", "ddim_cfg", 50, 16.2302, 9.3210, guidance_scale=5.0),
}

GROUP_CONFIG = {
    # group -> config shipped in this repo that builds the matching model
    "ddpm": "configs/ddpm_cifar10.yaml",
    "ddpm_pred_x0": "configs/ddpm_cifar10.yaml",
    "ddpm_pred_v": "configs/ddpm_cifar10.yaml",
    "ddpm_ip": "configs/ddpm_ip_cifar10.yaml",
    "cfg": "configs/ddpm_cfg_cifar10.yaml",
}

# group -> model prediction target; the pred_x0/pred_v checkpoints must be
# evaluated with a matching sampler objective or every row is garbage.
GROUP_OBJECTIVE = {
    "ddpm": "pred_eps",
    "ddpm_pred_x0": "pred_x0",
    "ddpm_pred_v": "pred_v",
    "ddpm_ip": "pred_eps",
    "cfg": "pred_eps",
}


# ---------------------------------------------------------------------------
# Comparison machinery (pure; self-tested without artifacts)
# ---------------------------------------------------------------------------


def within_tolerance(measured: float, expected: float, rel: float,
                     abs_tol: float) -> bool:
    """True if measured is within rel OR abs_tol of expected (either passes:
    rel covers big-FID rows, abs covers near-zero ones)."""
    return (abs(measured - expected) <= abs_tol
            or abs(measured - expected) <= rel * abs(expected))


def diff_table(results: dict, fid_rel: float, fid_abs: float,
               is_rel: float) -> tuple:
    """results: {row_id: {"fid": x, "is_mean": y}} -> (lines, n_failed)."""
    lines = [f"{'row':<18} {'FID meas':>9} {'FID ref':>9} "
             f"{'IS meas':>8} {'IS ref':>8}  verdict"]
    failed = 0
    for rid, meas in results.items():
        ref = ROWS[rid]
        ok_fid = within_tolerance(meas["fid"], ref["fid"], fid_rel, fid_abs)
        ok_is = within_tolerance(meas["is_mean"], ref["is_mean"], is_rel, 0.0)
        ok = ok_fid and ok_is
        failed += 0 if ok else 1
        out = [w for w, bad in (("FID out", not ok_fid), ("IS out", not ok_is))
               if bad]
        why = f" ({' + '.join(out)})" if out else ""
        lines.append(f"{rid:<18} {meas['fid']:>9.4f} {ref['fid']:>9.4f} "
                     f"{meas['is_mean']:>8.4f} {ref['is_mean']:>8.4f}  "
                     f"{'PASS' if ok else 'FAIL'}{why}")
    return lines, failed


def missing_artifacts(args) -> list:
    """Exact list of absent artifacts for the selected rows."""
    missing = []
    if not args.inception_weights or not os.path.isfile(args.inception_weights):
        missing.append(
            "inception weights: pass --inception_weights "
            "pt_inception-2015-12-05.pth (std torch-fidelity/pytorch-fid "
            f"file; got {args.inception_weights!r})")
    cifar = os.path.join(os.path.expanduser(args.cifar10_dir or ""),
                         "cifar-10-batches-py", "data_batch_1")
    if not args.cifar10_dir or not (
            os.path.isfile(cifar)
            or os.path.isfile(os.path.join(
                os.path.expanduser(args.cifar10_dir), "data_batch_1"))):
        missing.append(
            "CIFAR-10: pass --cifar10_dir containing cifar-10-batches-py/ "
            f"(python pickle batches; got {args.cifar10_dir!r})")
    if not args.weights or not os.path.exists(args.weights):
        missing.append(
            f"checkpoint for group {args.group!r}: pass --weights (an upstream "
            "torch checkpoint in the model's keys, a state.pt trained by "
            "python -m dmtpu_torch.scripts.train_ddpm, or a JAX-package .npz "
            f"export; got {args.weights!r})")
    return missing


def self_test() -> int:
    """Machinery check without any artifact: closed-form Fréchet distance on
    synthetic Gaussian stats + the tolerance/diff logic on fake numbers."""
    # two isotropic Gaussians in R^4: FID = |mu1-mu2|^2 + (s1-s2)^2 * d
    mu1, mu2 = np.zeros(4), np.full(4, 0.5)
    s1, s2 = 1.0, 2.0
    want = float(np.sum((mu1 - mu2) ** 2) + 4 * (s1 - s2) ** 2)
    got = frechet_distance(mu1, np.eye(4) * s1 ** 2, mu2, np.eye(4) * s2 ** 2)
    assert abs(got - want) < 1e-6, f"frechet closed-form: {got} != {want}"

    assert within_tolerance(3.10, 3.0459, rel=0.05, abs_tol=0.3)   # abs pass
    assert within_tolerance(270.0, 266.754, rel=0.05, abs_tol=0.3)  # rel pass
    assert not within_tolerance(3.8, 3.0459, rel=0.05, abs_tol=0.3)

    fake = {"ddpm_large_1000": {"fid": 3.1, "is_mean": 9.40},
            "ddim_50": {"fid": 9.9, "is_mean": 8.70}}
    lines, failed = diff_table(fake, fid_rel=0.05, fid_abs=0.3, is_rel=0.03)
    assert failed == 1 and "FAIL (FID out)" in lines[2], lines
    # exactly-on-tolerance IS failure path
    l2, f2 = diff_table({"ddim_50": {"fid": 7.70, "is_mean": 8.0}},
                        fid_rel=0.05, fid_abs=0.3, is_rel=0.03)
    assert f2 == 1 and "(IS out)" in l2[1], l2
    # both metrics out: the verdict must name BOTH (a hidden IS failure
    # costs a full re-evaluation run to discover)
    l3, f3 = diff_table({"ddim_50": {"fid": 99.0, "is_mean": 2.0}},
                        fid_rel=0.05, fid_abs=0.3, is_rel=0.03)
    assert f3 == 1 and "(FID out + IS out)" in l3[1], l3
    # every pred_x0/pred_v row's group carries a matching objective
    for rid, row in ROWS.items():
        want = ("pred_x0" if "_x0_" in rid
                else "pred_v" if "_v_" in rid else "pred_eps")
        assert GROUP_OBJECTIVE[row["group"]] == want, (rid, row)
    print("accept.py self-test: machinery OK "
          f"({len(ROWS)} baseline rows registered)")
    return 0


# ---------------------------------------------------------------------------
# The real run (artifact-gated)
# ---------------------------------------------------------------------------


def build_diffuser(row: dict) -> Any:
    """The row's sampler over 1000 uniform-respaced training steps."""
    base = dict(total_steps=1000, respace_type="uniform", respace_steps=row["steps"],
                objective=GROUP_OBJECTIVE[row["group"]])
    if row["sampler"] == "ddpm":
        return DDPM(var_type=row["var_type"], **base)
    if row["sampler"] == "ddim":
        return DDIM(eta=row.get("eta", 0.0), **base)
    if row["sampler"] == "euler":
        return EulerSampler(**base)
    if row["sampler"] == "heun":
        return HeunSampler(**base)
    if row["sampler"] == "ddim_cfg":
        return DDIMCFG(guidance_scale=row["guidance_scale"], eta=0.0, **base)
    raise ValueError(row["sampler"])


def to_uint8(samples: torch.Tensor) -> np.ndarray:
    """Samples [B, C, H, W] in [-1, 1] -> uint8 NHWC on the host, truncated
    as the JAX script does (``((clip(x, -1, 1) + 1) * 127.5).astype(uint8)``;
    rounding would move every FID)."""
    x = samples.detach().float().permute(0, 2, 3, 1).cpu().numpy()
    return ((np.clip(x, -1, 1) + 1) * 127.5).astype(np.uint8)


@torch.no_grad()
def sample_row(model: torch.nn.Module, diffuser: Any, n_samples: int, batch_size: int,
               shape: Sequence[int], seed: int, device: torch.device,
               num_classes: int = 0) -> np.ndarray:
    """``n_samples`` uint8 NHWC samples of ``model`` through ``diffuser``, in
    batches of ``amortize(n_samples, batch_size)``; ``num_classes`` > 0 runs
    the class-conditional group: balanced classes over the run, the null
    class ``num_classes`` as the unconditional branch."""
    if num_classes:
        def model_fn(x, t, y=None, **kw):
            return model(x, t, y)
    else:
        def model_fn(x, t, **kw):
            return model(x, t)
    images = []
    for i, bs in enumerate(amortize(n_samples, batch_size)):
        generator = fold_generator(seed, i, device)
        noise = torch.randn(bs, *shape, generator=generator, device=device)
        kw = {}
        if num_classes:
            y = (torch.arange(bs, device=device) + i * batch_size) % num_classes
            kw = dict(uncond_conditioning=torch.full((bs,), num_classes, dtype=torch.int64,
                                                     device=device),
                      model_kwargs=dict(y=y))
        images.append(to_uint8(diffuser.sample(model_fn, noise, generator, **kw)))
    return np.concatenate(images)[:n_samples]


def run_rows(args, row_ids, device: torch.device, overrides: Sequence[str] = ()) -> int:
    logger = get_logger()
    args.config = args.config or os.path.join(REPO, GROUP_CONFIG[args.group])
    conf = load_conf(args, overrides)
    model = instantiate_from_config(conf["model"], device=device)
    model = load_model_params(args.weights, model).eval()
    shape = image_shape(conf)
    num_classes = int(conf["data"].get("num_classes", 0) or 0) if args.group == "cfg" else 0
    logger.info(f"loaded {args.weights} for group {args.group} on {device}")

    ext = InceptionFeatureExtractor(args.inception_weights, batch_size=args.eval_batch_size,
                                    device=device)
    real = CIFAR10(args.cifar10_dir, split="train", transform_type="none")
    real_u8 = real.images[:args.n_samples] if args.n_samples else real.images
    logger.info(f"real side: {real_u8.shape[0]} CIFAR-10 train images")
    real_pool3 = ext(real_u8)

    results = {}
    for rid in row_ids:
        row = ROWS[rid]
        t0 = time.perf_counter()
        fake_u8 = sample_row(model, build_diffuser(row), args.n_samples, args.batch_size, shape,
                             args.seed, device, num_classes)
        t1 = time.perf_counter()
        pool3, probs = ext.features_and_probs(fake_u8)
        t2 = time.perf_counter()
        fid = fid_from_features(real_pool3, pool3)
        is_m, is_s = inception_score(probs, splits=args.is_splits)
        results[rid] = {"fid": float(fid), "is_mean": float(is_m),
                        "is_std": float(is_s)}
        logger.info(f"{rid}: FID {fid:.4f} (ref {row['fid']}) "
                    f"IS {is_m:.4f}±{is_s:.4f} (ref {row['is_mean']}); sampled "
                    f"{len(fake_u8)} in {t1 - t0:.2f} s, features {t2 - t1:.2f} s, "
                    f"statistics {time.perf_counter() - t2:.2f} s")

    lines, failed = diff_table(results, args.fid_tol_rel, args.fid_tol_abs,
                               args.is_tol_rel)
    print("\n".join(lines))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": results, "failed": failed,
                       "n_samples": args.n_samples}, f, indent=1)
    return 1 if failed else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--group", choices=sorted(GROUP_CONFIG), default="ddpm")
    p.add_argument("--rows", default=None,
                   help="comma-separated row ids (default: all rows of --group)")
    p.add_argument("--list", action="store_true", help="list rows and exit")
    p.add_argument("--self_test", action="store_true",
                   help="check the compare machinery with synthetic stats")
    p.add_argument("--weights", default=os.environ.get("DMTPU_ACCEPT_WEIGHTS"))
    p.add_argument("--config", default=None,
                   help="override the group's default model config")
    p.add_argument("--inception_weights",
                   default=os.environ.get("DMTPU_INCEPTION_WEIGHTS"))
    p.add_argument("--cifar10_dir", default=os.environ.get("DMTPU_DATA_DIR"))
    p.add_argument("--n_samples", type=int, default=50000)
    p.add_argument("--batch_size", type=int, default=500)
    p.add_argument("--eval_batch_size", type=int, default=128)
    p.add_argument("--is_splits", type=int, default=10,
                   help="IS split count (torch-fidelity default 10)")
    p.add_argument("--seed", type=int, default=2022)
    p.add_argument("--fid_tol_rel", type=float, default=0.05)
    p.add_argument("--fid_tol_abs", type=float, default=0.3)
    p.add_argument("--is_tol_rel", type=float, default=0.03)
    p.add_argument("--out", default=None, help="write JSON results here")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; exit 2 without a card) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = build_parser()
    args, unknown = p.parse_known_args(argv)
    bad = [a for a in unknown if "=" not in a]
    if bad:
        p.error(f"unrecognized arguments: {' '.join(bad)} (config overrides are key=value)")

    if args.self_test:
        sys.exit(self_test())

    if args.rows:
        row_ids = [r.strip() for r in args.rows.split(",")]
        bad = [r for r in row_ids if r not in ROWS]
        if bad:
            p.error(f"unknown rows: {bad}; see --list")
        groups = {ROWS[r]["group"] for r in row_ids}
        if len(groups) > 1:
            p.error(f"rows span checkpoints {sorted(groups)}; run per group")
        args.group = groups.pop()
    else:
        row_ids = [r for r, v in ROWS.items() if v["group"] == args.group]

    if args.list:
        for rid in row_ids:
            print(f"{rid:<18} {ROWS[rid]}")
        sys.exit(0)

    missing = missing_artifacts(args)
    if missing:
        print("accept.py: cannot run — missing artifacts:")
        for m in missing:
            print(f"  - {m}")
        sys.exit(2)
    try:
        device = resolve_device(args.device, cli="accept")
    except RuntimeError as e:
        print(f"accept.py: cannot run — {e}")
        sys.exit(2)
    sys.exit(run_rows(args, row_ids, device, unknown))


if __name__ == "__main__":
    main()
