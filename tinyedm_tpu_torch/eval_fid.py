"""FID evaluation: dataset statistics, then samples from a checkpoint scored
against them.

Counterpart of ``experiments/eval_fid.py``, with its subcommands and flags,
plus ``--device`` (the card unless ``cpu`` is asked for). Samples come from
the port's ``generate()`` with ``--ckpt_path``; ``sweep
--posthoc_sigma_rels`` reconstructs each post-hoc EMA with the port's
``posthoc_ema`` first. ``--features``: ``inception`` (the default; verified
local weights, ``utils/inception.py``), ``inception-unverified`` (a
rehearsal weight file: its numbers are NOT Inception FIDs), ``proxy``, or a
module exposing ``feature_fn()``; nothing falls back to another. A score
that is not an Inception FID is printed with its kind, as ``FID[proxy]``.
``--num_classes 0`` (the default) samples with the model's own class count.

    # reference statistics, once (CIFAR-10 pickle batches, MNIST IDX files or a PNG directory)
    python -m tinyedm_tpu_torch.eval_fid stats --data-dir datasets/cifar10 --out cifar_stats.npz
    # a checkpoint: 50k Heun-32 samples at batch 128; --kid and --prdc need stats with --kid-features
    python -m tinyedm_tpu_torch.eval_fid score --ckpt_path runs/cifar10/checkpoints \\
        --stats cifar_stats.npz --num_samples 50000 --load_ema --kid
    # every checkpoint step (x EMA profile), reconstructed post-hoc EMAs, or guidance scales
    python -m tinyedm_tpu_torch.eval_fid sweep --ckpt_path runs/cifar10/checkpoints \\
        --stats cifar_stats.npz --load_ema --ema_indices 0 1
    python -m tinyedm_tpu_torch.eval_fid sweep --ckpt_path runs/imagenet512/checkpoints \\
        --stats stats.npz --posthoc_sigma_rels 0.05 0.1 0.15
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path


def cmd_stats(args) -> None:
    from tinyedm_tpu_torch.utils.fid import (
        compute_stats,
        compute_stats_and_features,
        png_dir_batches,
        resolve_feature_fn,
        save_stats,
    )

    feature_fn, kind = resolve_feature_fn(args.features, args.device)
    if args.format == "png_dir":
        batches = lambda: png_dir_batches(args.data_dir, args.batch_size)  # noqa: E731
    else:
        from tinyedm_tpu_torch.data.datamodules import CIFAR10DataModule, MNISTDataModule

        cls = {"cifar10": CIFAR10DataModule, "mnist": MNISTDataModule}[args.format]
        dm = cls(batch_size=args.batch_size, data_dir=args.data_dir)
        dm.setup()

        def batches():
            for start in range(0, len(dm.train_images), args.batch_size):
                yield dm.train_images[start : start + args.batch_size]

    # a feature subsample makes `score --kid/--prdc` possible against this
    # file; 0 takes the moments-only path (None would keep every row)
    if args.kid_features:
        mu, sigma, feats = compute_stats_and_features(batches(), feature_fn, max_features=args.kid_features)
    else:
        mu, sigma = compute_stats(batches(), feature_fn)
        feats = None
    save_stats(args.out, mu, sigma, features=feats)
    kid_note = f" + {len(feats)} KID rows" if feats is not None else ""
    print(f"wrote stats ({len(mu)}-d {kind} features{kid_note}) to {args.out}")


def _generate_samples(args, sample_dir, ckpt_step=None, ema_index=None) -> dict:
    from tinyedm_tpu_torch.generate import generate

    return generate(
        str(sample_dir),
        args.num_samples,
        args.image_size,
        args.batch_size,
        ckpt_path=args.ckpt_path,
        load_ema=args.load_ema,
        ckpt_step=ckpt_step,
        ema_index=ema_index if ema_index is not None else 0,
        device=args.device,
        num_steps=args.num_steps,
        mean=tuple(args.mean),
        std=tuple(args.std),
        seed=args.seed,
        num_classes=args.num_classes or None,
        num_channels=args.num_channels,
        solver=args.solver,
        guidance_scale=args.guidance_scale,
        guide_ckpt_path=args.guide_ckpt_path,
        guide_ckpt_step=args.guide_ckpt_step,
        guide_ema_index=args.guide_ema_index,
        guidance_sigma_min=args.guidance_sigma_min,
        guidance_sigma_max=args.guidance_sigma_max,
    )


def _score_sample_dir(args, sample_dir, feature_fn) -> dict:
    """FID (and KID, PRDC where asked) of a PNG directory against args.stats."""
    from tinyedm_tpu_torch.utils.fid import (
        compute_stats,
        compute_stats_and_features,
        frechet_distance,
        kid_score,
        load_features,
        load_stats,
        png_dir_batches,
        prdc,
    )

    if args.kid or args.prdc:
        ref_feats = load_features(args.stats)
        if ref_feats is None:
            raise SystemExit(
                f"{args.stats} has no stored feature rows - regenerate it with `stats --kid-features N` to "
                "enable KID/PRDC"
            )
        mu1, s1, sample_feats = compute_stats_and_features(
            png_dir_batches(sample_dir, args.batch_size), feature_fn,
            max_features=max(args.kid_subset_size, len(ref_feats)),
        )
    else:
        mu1, s1 = compute_stats(png_dir_batches(sample_dir, args.batch_size), feature_fn)
    mu2, s2 = load_stats(args.stats)
    out = {"fid": frechet_distance(mu1, s1, mu2, s2)}
    if args.kid:
        out["kid"] = kid_score(sample_feats, ref_feats, subset_size=args.kid_subset_size,
                               num_subsets=args.kid_subsets)
    if args.prdc:
        out.update(prdc(ref_feats, sample_feats, k=args.prdc_k))
    return out


def _result_note(args, res, tag) -> str:
    note = f"  KID{tag}: {res['kid'] * 1e3:.4f} (x1e-3)" if args.kid else ""
    if args.prdc:
        note += f"  P {res['precision']:.3f} R {res['recall']:.3f} D {res['density']:.3f} C {res['coverage']:.3f}"
    return note


def cmd_score(args) -> dict:
    from tinyedm_tpu_torch.utils.fid import resolve_feature_fn

    if args.skip_generate and not args.sample_dir:
        raise SystemExit("--skip_generate requires --sample_dir")
    sample_dir = args.sample_dir or tempfile.mkdtemp(prefix="fid_samples_")
    if not args.skip_generate:
        _generate_samples(args, sample_dir)
    feature_fn, kind = resolve_feature_fn(args.features, args.device)
    tag = "" if kind == "inception" else f"[{kind}]"
    t0 = time.perf_counter()
    res = _score_sample_dir(args, sample_dir, feature_fn)
    res["score_seconds"] = time.perf_counter() - t0
    print(f"FID{tag}: {res['fid']:.3f}")
    if args.kid:
        print(f"KID{tag}: {res['kid'] * 1e3:.4f} (x1e-3)")  # reported x 10^3 by convention
    if args.prdc:
        print(f"PRDC{tag}: precision {res['precision']:.3f}  recall {res['recall']:.3f}  density "
              f"{res['density']:.3f}  coverage {res['coverage']:.3f}")
    return res


def _sweep_progress(n_configs: int, args):
    """Print the sweep's model-forward bill up front; returns a tick(label)
    that prints each configuration's average time and the ETA."""
    fwd = (2 * args.num_steps - 1) if args.solver == "heun" else args.num_steps
    # a guided solve runs a second branch per forward; CFG at scale 1 is the
    # plain model, autoguidance keeps its two forwards at any scale
    if args.guidance_scales:
        n_guided = sum(1 for s in args.guidance_scales if args.guide_ckpt_path is not None or s != 1.0)
    else:
        guided = args.guide_ckpt_path is not None or args.guidance_scale not in (None, 1.0)
        n_guided = n_configs if guided else 0
    total = args.num_samples * fwd * (n_configs + n_guided)
    print(f"sweep: {n_configs} configs x {args.num_samples} samples x {fwd} solver forwards ({args.solver}, "
          f"num_steps={args.num_steps})" + (f" (+{n_guided} guided configs x2)" if n_guided else "")
          + f" = {total / 1e6:.1f}M model forwards total; shared noise bank (seed {args.seed}) - rows differ by "
          "model/EMA/guidance only, not sampling noise")
    t0 = time.time()
    done = 0

    def tick(label: str) -> None:
        nonlocal done
        done += 1
        dt = time.time() - t0
        eta = dt / done * (n_configs - done)
        print(f"[{done}/{n_configs}] {label}: {dt / done:.0f}s/config avg"
              + (f", ETA {eta / 60:.1f} min" if done < n_configs else ""))

    return tick


def cmd_sweep(args) -> list:
    """Score every checkpoint step (x EMA profile), or with
    ``--posthoc_sigma_rels`` reconstructed post-hoc EMAs (EDM2's selection
    of sigma_rel), or with ``--guidance_scales`` the guidance strength at
    one checkpoint; prints the best row. Returns (label, result) rows."""
    from tinyedm_tpu_torch.utils.fid import resolve_feature_fn

    if args.guidance_scales and args.posthoc_sigma_rels:
        raise SystemExit("--guidance_scales and --posthoc_sigma_rels are separate sweep axes - pass one")
    for flag, vals in (("--guidance_scales", args.guidance_scales),
                       ("--posthoc_sigma_rels", args.posthoc_sigma_rels),
                       ("--steps", args.steps),
                       ("--ema_indices", args.ema_indices if args.load_ema else None)):
        # an empty list would fall through to sweeping every checkpoint
        if vals is not None and not vals:
            raise SystemExit(f"{flag} needs at least one value")
    if not args.load_ema and args.ema_indices != [0]:
        raise SystemExit("--ema_indices needs --load_ema")
    feature_fn, kind = resolve_feature_fn(args.features, args.device)
    tag = "" if kind == "inception" else f"[{kind}]"
    base = Path(args.sample_dir or tempfile.mkdtemp(prefix="fid_sweep_"))
    rows = []
    if args.guidance_scales:
        tick = _sweep_progress(len(args.guidance_scales), args)
        for scale in args.guidance_scales:
            sdir = base / f"gs{scale:g}"
            sub = argparse.Namespace(**vars(args))
            sub.guidance_scale = scale
            _generate_samples(sub, sdir, ckpt_step=args.ckpt_step,
                              ema_index=args.ema_indices[0] if args.load_ema else None)
            res = _score_sample_dir(args, sdir, feature_fn)
            rows.append((f"guidance_scale {scale:g}", res))
            print(f"guidance_scale {scale:g}  FID{tag}: {res['fid']:.3f}{_result_note(args, res, tag)}")
            tick(f"guidance_scale {scale:g}")
    elif args.posthoc_sigma_rels:
        from tinyedm_tpu_torch.posthoc_ema import reconstruct

        tick = _sweep_progress(len(args.posthoc_sigma_rels), args)
        for sr in args.posthoc_sigma_rels:
            ckpt_dir = base / f"posthoc_{sr:g}" / "ckpt"
            reconstruct(args.ckpt_path, sr, str(ckpt_dir), steps=args.steps, device=args.device)
            sdir = base / f"posthoc_{sr:g}" / "samples"
            sub = argparse.Namespace(**vars(args))
            sub.ckpt_path = str(ckpt_dir)
            sub.load_ema = True  # the reconstruction is profile 0
            _generate_samples(sub, sdir, ema_index=0)
            res = _score_sample_dir(args, sdir, feature_fn)
            rows.append((f"sigma_rel {sr:g}", res))
            print(f"sigma_rel {sr:g}  FID{tag}: {res['fid']:.3f}{_result_note(args, res, tag)}")
            tick(f"sigma_rel {sr:g}")
    else:
        ckpt_root = Path(args.ckpt_path)
        steps = args.steps or sorted(int(p.name) for p in ckpt_root.iterdir() if p.is_dir() and p.name.isdigit())
        if not steps:
            raise SystemExit(f"no checkpoint step directories under {ckpt_root}")
        ema_indices = args.ema_indices if args.load_ema else [None]
        tick = _sweep_progress(len(steps) * len(ema_indices), args)
        for step in steps:
            for ema_index in ema_indices:
                sdir = base / (f"step{step}" + (f"_ema{ema_index}" if ema_index is not None else ""))
                _generate_samples(args, sdir, ckpt_step=step, ema_index=ema_index)
                res = _score_sample_dir(args, sdir, feature_fn)
                rows.append((f"step {step:>8}  ema {ema_index}", res))
                print(f"step {step:>8}  ema {ema_index}  FID{tag}: {res['fid']:.3f}{_result_note(args, res, tag)}")
                tick(f"step {step} ema {ema_index}")
    best = min(rows, key=lambda r: r[1]["fid"])
    print(f"BEST: {best[0]} FID{tag}: {best[1]['fid']:.3f}")
    return rows


def main(argv=None):
    """Run the subcommand; returns what it returns (the score's numbers,
    the sweep's rows)."""
    p = argparse.ArgumentParser(description="FID evaluation")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("stats", help="compute dataset reference statistics")
    ps.add_argument("--data-dir", required=True)
    ps.add_argument("--out", required=True)
    ps.add_argument("--batch-size", type=int, default=256)
    ps.add_argument("--features", default=None, help="inception | inception-unverified | proxy | a module path")
    ps.add_argument("--format", default="cifar10", choices=["cifar10", "mnist", "png_dir"],
                    help="cifar10 pickle batches, raw MNIST idx files, or any directory of PNGs")
    ps.add_argument("--kid-features", type=int, default=10000,
                    help="store a feature subsample of this many rows for `score --kid/--prdc` (0 disables)")
    ps.add_argument("--device", default=None, help="cuda (default) or cpu")
    ps.set_defaults(fn=cmd_stats)

    def add_common(pc):
        pc.add_argument("--ckpt_path", required=True)
        pc.add_argument("--stats", required=True)
        pc.add_argument("--num_samples", type=int, default=50000)
        pc.add_argument("--image_size", type=int, default=32)
        pc.add_argument("--num_classes", type=int, default=0, help="0: the model's own class count")
        pc.add_argument("--batch_size", type=int, default=128)
        pc.add_argument("--num_steps", type=int, default=32)
        pc.add_argument("--num_channels", type=int, default=None,
                        help="sample channels; must equal the model's (default: the model's)")
        pc.add_argument("--load_ema", action="store_true")
        pc.add_argument("--mean", type=float, nargs="+", default=[0.49139968, 0.48215841, 0.44653091])
        pc.add_argument("--std", type=float, nargs="+", default=[0.24703223, 0.24348513, 0.26158784])
        pc.add_argument("--sample_dir", default=None)
        pc.add_argument("--features", default=None,
                        help="inception (default) | inception-unverified | proxy | a module path")
        pc.add_argument("--seed", type=int, default=0,
                        help="noise-bank seed: every sweep row solves from the same per-index noise")
        pc.add_argument("--guidance_scale", type=float, default=None)
        pc.add_argument("--guide_ckpt_path", default=None)
        pc.add_argument("--guide_ckpt_step", type=int, default=None)
        pc.add_argument("--guide_ema_index", type=int, default=0)
        pc.add_argument("--guidance_sigma_min", type=float, default=0.0)
        pc.add_argument("--guidance_sigma_max", type=float, default=float("inf"))
        pc.add_argument("--solver", default="heun", choices=["heun", "dpmpp2m"])
        pc.add_argument("--kid", action="store_true", help="also KID (needs stats with --kid-features)")
        pc.add_argument("--kid_subset_size", type=int, default=1000)
        pc.add_argument("--kid_subsets", type=int, default=100)
        pc.add_argument("--prdc", action="store_true",
                        help="also precision/recall/density/coverage (needs stats with --kid-features)")
        pc.add_argument("--prdc_k", type=int, default=5)
        pc.add_argument("--device", default=None, help="cuda (default) or cpu")

    pc = sub.add_parser("score", help="generate + score a checkpoint")
    add_common(pc)
    pc.add_argument("--skip_generate", action="store_true", help="score an existing --sample_dir")
    pc.set_defaults(fn=cmd_score)

    pw = sub.add_parser("sweep", help="score every checkpoint step (x EMA profile); prints the best")
    add_common(pw)
    pw.add_argument("--steps", type=int, nargs="*", default=None,
                    help="checkpoint steps (default: all); with --posthoc_sigma_rels the snapshot steps")
    pw.add_argument("--ema_indices", type=int, nargs="*", default=[0], help="EMA profiles per step (--load_ema)")
    pw.add_argument("--posthoc_sigma_rels", type=float, nargs="*", default=None,
                    help="sweep reconstructed post-hoc EMAs at these sigma_rels")
    pw.add_argument("--guidance_scales", type=float, nargs="*", default=None,
                    help="sweep the guidance scale at one checkpoint")
    pw.add_argument("--ckpt_step", type=int, default=None, help="the step for --guidance_scales (default: latest)")
    pw.set_defaults(fn=cmd_sweep)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
