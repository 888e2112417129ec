"""Bring a site's own pretrained weights to the port in one command. Port of
``tools/import_real_weights.py``.

The shipped npz weights are a synthetic bootstrap; a production site drops
in real pretrained exports (an InsightFace RetinaFace and an ArcFace
embedder such as ``w600k_r50.onnx``):

    python -m frp_tpu_torch.tools.import_real_weights \\
        --detector det.onnx --embedder w600k_r50.onnx [--spoof m3.onnx] \\
        [--arch iresnet50] [--device cuda|cpu]

Per model: (1) VALIDATE: the ONNX graph imports structurally into the init
tree (the node-order walk of ``models/params.py``) and a forward on zeros
runs finite on ``--device``; (2) INSTALL: copy into ``<repo>/weights``
under the engine's first candidate names (retinaface.onnx, embedder.onnx,
spoof.onnx, which outrank the shipped npz); (3) RE-MEASURE: run
``calibrate_embedder`` and ``tiered_eval`` (and ``eval_spoof`` when the
spoof head changed) as ``python -m frp_tpu_torch.tools.<name> --device
<device>`` subprocesses, so that the distance scale and the accuracy tables
are derived again for the new weights.

``--dry-run`` validates only: no copy, no re-measurement. ``--device``
defaults to the card; the JAX tool validates on the CPU because a TPU takes
one process at a time, while the card is shared by this process and its
subprocesses.

Limits kept from the reference: the embedder is validated at 128-d
(``_validate`` builds the tree with ``embed_dim=128``), so a 512-d export
such as w600k_r50 fails validation here though the engine serves it with
``EMBED_DIM=512``; installs go to ``<repo>/weights``, not to
``WEIGHTS_DIR``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

# where this package is imported from, which the re-measuring children
# import it from too; installs go to REPO/weights, the same root
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPO = PACKAGE_ROOT

INSTALL_NAME = {"detector": "retinaface.onnx", "embedder": "embedder.onnx",
                "spoof": "spoof.onnx"}


def _validate(model: str, path: str, arch: str, device) -> None:
    """Structural import + a forward on zeros; exits on any mismatch."""
    import torch

    from frp_tpu_torch.engine.pipeline import load_onnx
    from frp_tpu_torch.models.params import convert_params, flatten_params, same_structure

    if model == "detector":
        from frp_tpu_torch.models.retinaface import init_retinaface, retinaface_forward

        tree, fwd, shape = init_retinaface(0), retinaface_forward, (1, 128, 128, 3)
    elif model == "embedder":
        if arch.startswith("iresnet"):
            from frp_tpu_torch.models.iresnet import init_iresnet, iresnet_forward

            tree, fwd = init_iresnet(0, variant=arch, embed_dim=128), iresnet_forward
        else:
            from frp_tpu_torch.models.mobilefacenet import (
                init_mobilefacenet,
                mobilefacenet_forward,
            )

            tree, fwd = init_mobilefacenet(0, embed_dim=128), mobilefacenet_forward
        shape = (1, 112, 112, 3)
    else:
        from frp_tpu_torch.models.mobilenetv3 import init_mobilenetv3_small, mobilenetv3_forward

        tree, fwd, shape = init_mobilenetv3_small(0, num_classes=2), mobilenetv3_forward, (1, 112, 112, 3)

    try:
        new = load_onnx(path, tree)
    except (ValueError, KeyError) as e:
        raise SystemExit(
            f"{model}: {os.path.basename(path)} does not match the "
            f"{arch if model == 'embedder' else model} structure: {e}")
    if not same_structure(tree, new):
        raise SystemExit(f"{model}: structure mismatch after import")
    with torch.no_grad():
        out = fwd(convert_params(new, device), torch.zeros(shape, device=device))
    leaves = out.values() if isinstance(out, dict) else [out]
    if not all(bool(torch.isfinite(v).all()) for v in leaves):
        raise SystemExit(f"{model}: forward pass produced non-finite values")
    print(f"  {model}: imported {os.path.basename(path)} "
          f"({len(flatten_params(new))} param leaves, forward OK on {device})")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--detector", help="RetinaFace-family ONNX export")
    p.add_argument("--embedder", help="face-embedder ONNX export (128-d)")
    p.add_argument("--spoof", help="MobileNetV3-Small 2-class ONNX export")
    p.add_argument("--arch", default="mobilefacenet",
                   help="embedder family the export matches structurally "
                        "(mobilefacenet | iresnet18 | ...). Also set "
                        "EMBEDDER_ARCH for serving.")
    p.add_argument("--dry-run", action="store_true",
                   help="validate only; no install, no re-measurement")
    p.add_argument("--skip-eval", action="store_true",
                   help="install without re-measuring (the engine will "
                        "refuse stale calibration: run the tools later)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    provided = {m: getattr(args, m) for m in INSTALL_NAME if getattr(args, m)}
    if not provided:
        p.error("provide at least one of --detector/--embedder/--spoof")

    from frp_tpu_torch.engine.pipeline import resolve_device

    device = resolve_device(args.device)
    print(f"validating on {device}:")
    for model, path in provided.items():
        _validate(model, path, args.arch, device)
    if args.dry_run:
        print("dry run: validation passed; nothing installed")
        return

    wd = os.path.join(REPO, "weights")
    for model, path in provided.items():
        dst = os.path.join(wd, INSTALL_NAME[model])
        shutil.copyfile(path, dst)
        print(f"installed {dst}")

    tool = "python -m frp_tpu_torch.tools."
    if args.skip_eval:
        print("skipped re-measurement (--skip-eval); before serving run:\n"
              f"  {tool}calibrate_embedder --arch {args.arch} --device {device.type}\n"
              f"  {tool}tiered_eval --arch {args.arch} --device {device.type}")
        return

    runs = []
    py = [sys.executable, "-m"]
    dev = ["--device", device.type]
    if "embedder" in provided or "detector" in provided:
        runs += [py + ["frp_tpu_torch.tools.calibrate_embedder", "--arch", args.arch] + dev,
                 py + ["frp_tpu_torch.tools.tiered_eval", "--arch", args.arch] + dev]
    if "spoof" in provided:
        runs.append(py + ["frp_tpu_torch.tools.eval_spoof"] + dev)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_ROOT] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep) if x])
    for cmd in runs:
        print("running:", " ".join(cmd), flush=True)
        subprocess.run(cmd, cwd=REPO, env=env, check=True)

    print(
        "\nDone. Expected artifact diff: weights/*.onnx installed, "
        "calibration{_arch}.json + tiered_eval{_arch}.json (and "
        "spoof_eval.json if --spoof) re-measured with new weights_sha256 "
        f"fields. Serve with EMBEDDER_ARCH={args.arch}.")


if __name__ == "__main__":
    main()
