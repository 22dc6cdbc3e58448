"""Rate-distortion comparison (port of `stf_tpu/cli/rd_compare.py`):
evaluate checkpoints and report BD-rate against the reference's published
curves.

    python -m stf_tpu_torch.cli.rd_compare -a cnn -d /path/kodak \
        -p cnn_0035.pth.tar cnn_0067.pth.tar ... \
        --baseline cnn_mse_Kodak [--device cpu]

Reads torch checkpoints (`stf_tpu_torch.zoo.load_any_checkpoint`: the
port's own, the trainer's and reference `.pth.tar` files). Missing
checkpoint paths are skipped with a notice (exit 0 with whatever points
exist; exit 0 and "no checkpoints present" when none do, so CI can run
this unconditionally). With >= 2 evaluated points it reports BD-rate and
BD-quality (Bjøntegaard); with 1 point, the interpolated rate delta
against the baseline curve at that point's quality. Points are compared
in the baseline's own quality metric.
"""

import argparse
import json
import math
import os
import sys
import tempfile


def setup_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-a", "--architecture", required=True)
    p.add_argument("-d", "--dataset", required=True)
    p.add_argument(
        "-p", "--paths", nargs="+", required=True,
        help="checkpoints, one per RD point (.pth, .pth.tar or .pt)",
    )
    p.add_argument(
        "--baseline",
        default=None,
        help="published-curve name (e.g. cnn_mse_Kodak; see "
        "stf_tpu_torch/zoo/published.py) or a JSON file with bpp/quality "
        "arrays. Default: <arch>_mse_Kodak",
    )
    p.add_argument("--entropy-estimation", action="store_true")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--recon-path", default=None, help="save reconstructions")
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device (default cuda, which raises where there is no "
        "card)",
    )
    return p


def load_baseline(name_or_path: str):
    """A published curve by name, or a JSON file: {"bpp", "quality"[,
    "metric"]}, or the reference's results/*.json layout, whose quality is
    PSNR or, for MS-SSIM-optimised models, -10*log10(1 - MS-SSIM) dB."""
    from ..zoo.published import PUBLISHED_RD

    if name_or_path in PUBLISHED_RD:
        return PUBLISHED_RD[name_or_path]
    with open(name_or_path) as f:
        blob = json.load(f)
    if "bpp" in blob:
        return blob
    # reference results/*.json layout: {"results": {"bpp": [...], "psnr": [...]}}
    res = blob["results"]
    if res.get("psnr") is not None:
        return {"bpp": res["bpp"], "quality": res["psnr"], "metric": "psnr"}
    return {
        "bpp": res["bpp"], "quality": res["ms-ssim"],
        "metric": "ms-ssim-db",
    }


def main(argv=None):
    args = setup_args().parse_args(argv)

    present = [p for p in args.paths if os.path.exists(p)]
    missing = [p for p in args.paths if not os.path.exists(p)]
    for p in missing:
        print(f"skipping missing checkpoint: {p}", file=sys.stderr)
    if not present:
        print(
            json.dumps({"name": args.architecture, "results": None,
                        "note": "no checkpoints present"})
        )
        return 0

    from ..models.codec import resolve_device
    from ..utils.bdrate import bd_quality, bd_rate, rate_delta_at_quality
    from ..zoo import load_any_checkpoint
    from .eval_model import collect_images, eval_model

    device = resolve_device(args.device)
    filepaths = collect_images(args.dataset)
    if not filepaths:
        print("Error: no images found in directory.", file=sys.stderr)
        return 1

    baseline_name = args.baseline or f"{args.architecture}_mse_Kodak"
    baseline = load_baseline(baseline_name)

    # compare in the BASELINE's quality metric: PSNR curves vs eval PSNR,
    # MS-SSIM curves vs -10*log10(1 - MS-SSIM) dB (never mix the two)
    metric = baseline.get("metric", "psnr")
    if metric == "ms-ssim-db" and args.entropy_estimation:
        print(
            "Error: --entropy-estimation computes no MS-SSIM; use a PSNR "
            "baseline or run real coding.",
            file=sys.stderr,
        )
        return 1

    bpps, qualities = [], []
    recon = args.recon_path or tempfile.mkdtemp(prefix="rd_recon_")
    for path in present:
        model = load_any_checkpoint(path, args.architecture, device=device)
        metrics = eval_model(
            model,
            filepaths,
            entropy_estimation=args.entropy_estimation,
            recon_path=recon,
            batch_size=args.batch_size,
            device=device,
        )
        if metric == "ms-ssim-db":
            q = -10 * math.log10(max(1 - metrics["ms-ssim"], 1e-12))
        else:
            q = metrics["psnr"]
        bpps.append(metrics["bpp"])
        qualities.append(q)
        print(
            f"{path}: bpp={metrics['bpp']:.4f} {metric}={q:.2f}",
            file=sys.stderr,
        )

    out = {
        "name": args.architecture,
        "dataset": args.dataset,
        "baseline": baseline_name,
        "metric": metric,
        "results": {"bpp": bpps, metric: qualities},
    }
    if len(bpps) >= 2:
        out["bd_rate_pct"] = bd_rate(
            baseline["bpp"], baseline["quality"], bpps, qualities
        )
        out["bd_quality_db"] = bd_quality(
            baseline["bpp"], baseline["quality"], bpps, qualities
        )
    else:
        try:
            out["rate_delta_pct"] = rate_delta_at_quality(
                baseline["bpp"], baseline["quality"], bpps[0], qualities[0]
            )
        except ValueError as e:
            out["rate_delta_pct"] = None
            out["note"] = str(e)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
