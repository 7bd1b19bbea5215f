"""End-to-end product demo on the PyTorch/CUDA port: train -> attack ->
defend -> evaluate.

The port of `tools/e2e_demo.py`: the same stages and `results.json`, on
the port's CLIs, with `--device` (default `cuda:0`, one card) passed to
every CLI. Runs on the card unless given `--device cpu`; without a card it
exits with an error. The synthetic 8-class shape family
(`tools/synthetic_dataset.py`, numpy only) stands in for ModelNet40:

  1. train PointNet on synth8            (expect high clean accuracy)
  2. CW-Perturb targeted attack          (accuracy collapses)
  3. SOR baseline defense                (partial recovery)
  4. train ConvONet on synth8 occupancy
  5. ConvONet-Opt IF-Defense             (stronger recovery)
  6. ConvONet-Mesh IF-Defense            (dense-lattice mesh path)

Usage: python tools/e2e_demo_torch.py --out_dir runs/e2e [--fast]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the stages' sizes, as `tools/e2e_demo.py` sets them
SIZES = {
    "full": dict(train_pc=200, test_pc=40, epochs=40, cw_steps=(8, 300),
                 occ_steps=4000, defense_iters=200, occ_per_class=60,
                 num_points=1024, batch=40, mesh=()),
    "fast": dict(train_pc=60, test_pc=15, epochs=10, cw_steps=(2, 50),
                 occ_steps=300, defense_iters=50, occ_per_class=30,
                 num_points=1024, batch=40,
                 mesh=("--resolution0", "16", "--upsample", "2")),
}


def main(argv=None, sizes: dict | None = None):
    """Run the loop; the stages' accuracies. `sizes` (for tests) replaces
    entries of the sizes that `--fast` picks."""
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir",
                   default=os.path.join(ROOT, "runs", "e2e"),
                   help="default runs/e2e in this checkout")
    p.add_argument("--fast", action="store_true",
                   help="reduced sizes for smoke runs")
    p.add_argument("--interp_refresh", type=int, default=1,
                   help="opt-defense corner-cache refresh window "
                        "(accuracy A/B for the fast path)")
    p.add_argument("--device", default="cuda:0",
                   help="torch device of every CLI (default one card, "
                        "cuda:0; cpu only when asked)")
    args = p.parse_args(argv)
    from if_defense_tpu_torch.cli import device_of
    from if_defense_tpu_torch.utils.determinism import CUBLAS_WORKSPACE

    # before any CUDA work: the attack CLI's deterministic algorithms need
    # cuBLAS's workspace, read when the first handle is made (in training)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    device_of(args.device)          # exits where no card is and none asked
    s = {**SIZES["fast" if args.fast else "full"], **(sizes or {})}
    os.makedirs(args.out_dir, exist_ok=True)
    dev = ["--device", args.device]
    npts, batch = str(s["num_points"]), str(s["batch"])
    results = {}

    from tools.synthetic_dataset import main as make_data

    cls_npz, occ_npz = make_data([
        "--out_dir", args.out_dir,
        "--train_per_class", str(s["train_pc"]),
        "--test_per_class", str(s["test_pc"]),
        "--occ_per_class", str(s["occ_per_class"]),
        "--num_points", npts,
    ])

    # 1. train the victim
    from if_defense_tpu_torch.cli.train import main as train_main

    run_dir = os.path.join(args.out_dir, "pointnet")
    best_acc = train_main([
        "--data", cls_npz, "--model", "pointnet", "--num_points", npts,
        "--epochs", str(s["epochs"]), "--batch_size", "32",
        "--eval_every", "5", "--output", run_dir,
        # keep a checked-in registry untouched
        "--registry", os.path.join(args.out_dir, "registry.json"), *dev,
    ])
    results["clean_accuracy"] = best_acc
    ckpt = os.path.join(run_dir, "best.npz")

    # 2. attack
    from if_defense_tpu_torch.cli.attack import main as attack_main

    adv_path, success = attack_main([
        "--attack", "perturb", "--data", cls_npz, "--checkpoint", ckpt,
        "--num_points", npts, "--batch_size", batch,
        "--binary_step", str(s["cw_steps"][0]),
        "--num_iter", str(s["cw_steps"][1]),
        "--output", os.path.join(args.out_dir, "perturb-pointnet.npz"), *dev,
    ])
    results["attack_success_rate"] = success

    from if_defense_tpu_torch.cli.inference import main as inf_main

    def acc_of(path):
        out = inf_main([
            "--data", path, "--checkpoint", ckpt, "--num_points", npts,
            "--batch_size", batch, "--mode", "target", *dev,
        ])
        return out["accuracy"], out.get("target_success")

    results["attacked_accuracy"], results["attacked_target_success"] = (
        acc_of(adv_path))

    # 3. SOR baseline defense
    from if_defense_tpu_torch.cli.defend_npz import main as defend_main

    sor_path, = defend_main([
        "--data_root", adv_path, "--defense", "sor", "--batch_size", batch,
        *dev])
    results["sor_accuracy"], _ = acc_of(sor_path)

    # 4. train ConvONet on the same shape family
    from if_defense_tpu_torch.cli.train_implicit import main as timpl_main

    weights = timpl_main([
        "--variant", "convonet", "--data", occ_npz,
        "--steps", str(s["occ_steps"]), "--batch_size", "16",
        "--log_every", "200", "--save_every", str(s["occ_steps"]),
        "--output", os.path.join(args.out_dir, "convonet_synth"), *dev,
    ])

    # 5. ConvONet-Opt IF-Defense
    from if_defense_tpu_torch.cli.opt_defense import main as opt_main

    opt_path, = opt_main([
        "--variant", "convonet", "--data_root", adv_path,
        "--weights", weights, "--iterations", str(s["defense_iters"]),
        "--batch_size", batch,
        "--interp_refresh", str(args.interp_refresh), *dev,
    ])
    results["convonet_opt_accuracy"], _ = acc_of(opt_path)

    # 6. ConvONet-Mesh IF-Defense (dense-lattice generation path)
    from if_defense_tpu_torch.cli.remesh_defense import main as remesh_main

    mesh_path, = remesh_main([
        "--variant", "convonet", "--data_root", adv_path,
        "--weights", weights, "--batch_size", batch, *s["mesh"], *dev,
    ])
    results["convonet_mesh_accuracy"], _ = acc_of(mesh_path)

    print(json.dumps(results, indent=2, default=float))
    with open(os.path.join(args.out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    return results


if __name__ == "__main__":
    main()
