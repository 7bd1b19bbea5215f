"""Attack CLI: run any of the seven attack families over an npz dataset
(port of `if_defense_tpu/cli/attack.py`).

Writes one adversarial npz (`test_pc`, `test_label`, `target_label`) and a
`.metrics.jsonl` beside it. The flags are the JAX CLI's, plus `--device`
(default `cuda`; `cpu` only when asked). It runs on one device, eagerly,
with TF32 off for matmuls and convolutions and under
`torch.use_deterministic_algorithms(True)` (restored when `main` returns),
so that a batch gives the same bits each time it is computed. Each batch
draws from its own `torch.Generator`, seeded from (`--seed`, batch index),
so a `--resume`d run replays the draws of the batches it computes. Resume
shards are fingerprinted by the results' arguments and the inputs'
contents; a directory of other shards is refused.

Usage:
    python -m if_defense_tpu_torch.cli.attack --attack perturb \\
        --data mn40_attack.npz --checkpoint victim.npz
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import shutil

import numpy as np
import torch

from if_defense_tpu_torch.attack import (
    chamfer_dist,
    chamfer_knn_dist,
    cw_add,
    cw_add_cluster,
    cw_add_object,
    cw_knn,
    cw_perturb,
    fgm,
    hausdorff_dist,
    ifgm,
    mifgm,
    pgd,
    saliency_drop,
)
from if_defense_tpu_torch.cli import device_of
from if_defense_tpu_torch.cli.inference import load_eval_model, resolve_checkpoint
from if_defense_tpu_torch.data import (
    ModelNet40Attack,
    ModelNet40NormalAttack,
    batch_iterator,
    save_npz,
)
from if_defense_tpu_torch.utils import MetricsWriter

ATTACKS = ["perturb", "add", "add_cluster", "add_object", "knn",
           "fgm", "ifgm", "mifgm", "pgd", "drop"]
# cuBLAS's deterministic workspace, needed under deterministic algorithms;
# it takes effect only where set before the process's first cuBLAS handle
CUBLAS_WORKSPACE = ":4096:8"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run a point-cloud attack")
    p.add_argument("--attack", required=True, choices=ATTACKS)
    p.add_argument("--data", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--model", default=None)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--output", default=None,
                   help="output npz (default <attack>-<model>-<file>.npz)")
    # CW params
    p.add_argument("--attack_lr", type=float, default=1e-2)
    p.add_argument("--binary_step", type=int, default=None)
    p.add_argument("--num_iter", type=int, default=None)
    p.add_argument("--adv_dist", default="chamfer",
                   choices=["chamfer", "hausdorff"],
                   help="distance for the Add attack")
    p.add_argument("--num_add", type=int, default=None)
    # FGM params
    p.add_argument("--budget", type=float, default=0.08)
    # kNN params
    p.add_argument("--knn_budget", type=float, default=0.1)
    p.add_argument("--kappa", type=float, default=15.0,
                   help="kNN-attack margin (targeted_knn_attack.py:81)")
    p.add_argument("--approx_knn", action="store_true",
                   help="accepted for the JAX CLI's sake: the port's kNN "
                        "selection is exact either way")
    # Drop params
    p.add_argument("--num_drop", type=int, default=200)
    p.add_argument("--victim_dtype", default="float32",
                   choices=["float32", "mixed"],
                   help="mixed = bf16 victim trunk + f32 logits head "
                        "(attack math stays f32; see attack/mixed.py)")
    p.add_argument("--device_chunk_iters", type=int, default=-1,
                   help="CW-family Adam iterations per segment; -1 = auto, "
                        "0 = one segment. Eager PyTorch launches every "
                        "iteration either way: results do not depend on it")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--registry", default=None,
                   help="registry JSON for registry:<dataset> checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="write per-batch shards to <output>.partial/ and "
                        "skip batches already done there; a resumed run "
                        "gives the same bits as an uninterrupted one")
    p.add_argument("--stop_after_batches", type=int, default=0,
                   help="compute at most N new batches then exit (0 = all);"
                        " with --resume a later invocation completes the "
                        "file")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    return p.parse_args(argv)


# arguments that do not change the results: execution shape and
# bookkeeping. The checkpoint is fingerprinted by its resolved path and
# content instead of its name and registry.
_NON_RESULT_ARGS = ("output", "resume", "stop_after_batches",
                    "device_chunk_iters", "registry", "checkpoint")


def _resume_fingerprint(args, resolved_checkpoint: str) -> dict:
    """The results' arguments, the checkpoint's path and content digest,
    and the data file's sha256."""
    fp = {k: v for k, v in sorted(vars(args).items())
          if k not in _NON_RESULT_ARGS}
    fp["checkpoint"] = os.path.abspath(resolved_checkpoint)
    fp["checkpoint_digest"] = _ckpt_digest_or_none(fp["checkpoint"])
    if getattr(args, "data", None):
        fp["data_sha256"] = _sha256_or_none(args.data)
    return fp


def _sha256_or_none(path: str):
    try:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()
    except OSError:
        return None


def _ckpt_digest_or_none(path: str, sample_bytes: int = 1 << 18):
    """Bounded content digest of a checkpoint file or directory (the JAX
    package's v2): each file's relative path, size, and head and tail
    `sample_bytes` (all of a file under 2 * sample_bytes), delimited."""
    h = hashlib.sha256()

    def hash_file(p, rel):
        size = os.path.getsize(p)
        h.update(rel.encode())
        h.update(b"\x00")
        h.update(str(size).encode())
        h.update(b"\x00")
        with open(p, "rb") as f:
            h.update(f.read(sample_bytes))
            if size > 2 * sample_bytes:
                f.seek(size - sample_bytes)
                h.update(f.read(sample_bytes))
            elif size > sample_bytes:
                h.update(f.read())
        h.update(b"\x01")

    try:
        if os.path.isdir(path):
            for root, dirs, files in sorted(os.walk(path)):
                dirs.sort()
                for name in sorted(files):
                    p = os.path.join(root, name)
                    hash_file(p, os.path.relpath(p, path))
        else:
            hash_file(path, os.path.basename(path))
        return "v2:" + h.hexdigest()
    except OSError:
        return None


def batch_generator(seed: int, batch: int,
                    device: torch.device) -> torch.Generator:
    """The draws of batch `batch`: a generator on `device` seeded from
    (seed, batch)."""
    state = np.random.SeedSequence([seed, batch]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


def build_attack(args, logits_fn, masked_logits_fn=None):
    """-> (run(pc, label, target, normal, generator) -> (adv, success),
    dataset mode). `masked_logits_fn(pc, mask)` is the mask-aware victim
    forward of the fixed-shape Drop attack."""
    name = args.attack
    chunk = None if args.device_chunk_iters <= 0 else args.device_chunk_iters
    cw = dict(attack_lr=args.attack_lr, device_chunk_iters=chunk)

    if name == "perturb":
        bsteps, iters = args.binary_step or 10, args.num_iter or 500

        def run(pc, label, target, normal, gen):
            _, adv, succ = cw_perturb(logits_fn, pc, target, gen,
                                      binary_step=bsteps, num_iter=iters,
                                      **cw)
            return adv, succ
        return run, "target"

    if name == "add":
        bsteps, iters = args.binary_step or 10, args.num_iter or 500
        dist = functools.partial(
            chamfer_dist if args.adv_dist == "chamfer" else hausdorff_dist,
            method="adv2ori")

        def run(pc, label, target, normal, gen):
            _, adv, succ = cw_add(logits_fn, pc, target, gen, dist,
                                  num_add=args.num_add or 512,
                                  binary_step=bsteps, num_iter=iters, **cw)
            return adv, succ
        return run, "target"

    if name in ("add_cluster", "add_object"):
        attack = cw_add_cluster if name == "add_cluster" else cw_add_object
        bsteps, iters = args.binary_step or 5, args.num_iter or 500

        def run(pc, label, target, normal, gen):
            _, adv, succ = attack(logits_fn, pc, target, gen,
                                  num_add=args.num_add or 3,
                                  binary_step=bsteps, num_iter=iters,
                                  seed=args.seed, **cw)
            return adv, succ
        return run, "target"

    if name == "knn":
        iters = args.num_iter or 2500

        def run(pc, label, target, normal, gen):
            return cw_knn(logits_fn, pc, target, gen, chamfer_knn_dist,
                          normal=normal, attack_lr=1e-3, num_iter=iters,
                          budget=args.knn_budget, kappa=args.kappa,
                          device_chunk_iters=chunk)
        return run, "target_normal"

    if name in ("fgm", "ifgm", "mifgm", "pgd"):
        iters = args.num_iter or 50
        # the global L2 budget scales by sqrt(K * 3), as the reference's
        # attack script's (targeted_fgm_attack.py:136-140)
        budget = args.budget * np.sqrt(args.num_points * 3)
        step_size = budget / iters
        iterative = {"ifgm": ifgm, "mifgm": mifgm, "pgd": pgd}.get(name)

        def run(pc, label, target, normal, gen):
            if iterative is None:
                return fgm(logits_fn, pc, target, budget)
            return iterative(logits_fn, pc, target, budget, step_size, iters,
                             generator=gen)
        return run, "target"

    if name == "drop":
        def run(pc, label, target, normal, gen):
            adv, still_correct = saliency_drop(masked_logits_fn, pc, label,
                                               args.num_drop)
            return adv, ~still_correct
        return run, "untarget"

    raise ValueError(name)


def _victim_fns(model, victim_dtype: str):
    """(logits_fn(pc), masked_logits_fn(pc, mask)) over the eval-mode
    victim, autograd on."""
    if victim_dtype == "mixed":
        from if_defense_tpu_torch.attack.mixed import make_mixed_logits_fn

        # the head is the victim's last Linear (every victim ends in one)
        n_cls = [m for m in model.modules()
                 if isinstance(m, torch.nn.Linear)][-1].out_features
        return (make_mixed_logits_fn(model, n_cls),
                make_mixed_logits_fn(model, n_cls, masked=True))
    return (lambda pc: model(pc)[0],
            lambda pc, mask: model(pc, mask)[0])


def _check_resume_dir(part_dir: str, fp: dict) -> None:
    """Record the fingerprint in a new shard directory, or refuse one whose
    shards came from another configuration or other inputs."""
    os.makedirs(part_dir, exist_ok=True)
    fp_path = os.path.join(part_dir, "config.json")
    if not os.path.exists(fp_path):
        with open(fp_path, "w") as f:
            json.dump(fp, f)
        return
    with open(fp_path) as f:
        old = json.load(f)
    if old != fp:
        raise ValueError(
            f"{part_dir} holds shards from a different attack configuration "
            f"or other inputs; delete it or change --output (old={old}, "
            f"new={fp})")


def _load_shard(path: str):
    """A committed shard, or None where it is missing or unreadable (an
    unreadable one is removed, to be recomputed)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as d:
            return {k: d[k] for k in ("adv", "label", "target", "succ",
                                      "valid")}
    except Exception as e:       # a truncated or garbled file, whatever
        print(f"  [resume] corrupt shard {path} ({type(e).__name__}) - "
              "recomputing", flush=True)
        os.remove(path)
        return None


def main(argv=None):
    args = parse_args(argv)
    device = device_of(args.device)
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _attack(args, device)
    finally:
        torch.use_deterministic_algorithms(deterministic)


def _attack(args, device: torch.device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    resolved_ckpt = resolve_checkpoint(
        args.checkpoint, args.model, args.num_points, args.registry)
    model, meta = load_eval_model(resolved_ckpt, args.model)
    model.to(device)
    for p in model.parameters():
        p.requires_grad_(False)
    logits_fn, masked_logits_fn = _victim_fns(model, args.victim_dtype)
    run, mode = build_attack(args, logits_fn, masked_logits_fn)

    if mode == "target_normal":
        ds = ModelNet40NormalAttack(args.data, args.num_points)
    else:
        ds = ModelNet40Attack(args.data, args.num_points)

    model_name = meta.get("model", args.model or "model")
    out = args.output or "{}-{}-{}".format(
        args.attack, model_name, os.path.basename(args.data))
    part_dir = out + ".partial"
    if args.resume:
        _check_resume_dir(part_dir, _resume_fingerprint(args, resolved_ckpt))

    all_adv, all_label, all_target = [], [], []
    success = total = computed = 0
    stopped_early = False
    for bi, (batch, valid) in enumerate(
            batch_iterator(ds, args.batch_size, pad_last=True)):
        shard_path = os.path.join(part_dir, f"batch_{bi:05d}.npz")
        shard = _load_shard(shard_path) if args.resume else None
        if shard is not None:
            all_adv.append(shard["adv"])
            all_label.append(shard["label"])
            all_target.append(shard["target"])
            success += int(shard["succ"].sum())
            total += int(shard["valid"])
            continue
        if args.stop_after_batches and computed >= args.stop_after_batches:
            stopped_early = True
            break
        pc_np = np.asarray(batch[0], np.float32)
        normal = None
        if pc_np.shape[-1] > 3:
            # contiguous: the victims' FPS and ball query kernels need it
            normal = torch.from_numpy(
                np.ascontiguousarray(pc_np[..., 3:6])).to(device)
            pc_np = np.ascontiguousarray(pc_np[..., :3])
        pc = torch.from_numpy(pc_np).to(device)
        label = torch.from_numpy(np.asarray(batch[1])).long().to(device)
        target = (torch.from_numpy(np.asarray(batch[2])).long().to(device)
                  if len(batch) > 2 else label)
        adv, succ = run(pc, label, target, normal,
                        batch_generator(args.seed, bi, device))
        adv, succ = adv.detach().cpu().numpy(), succ.cpu().numpy()
        b_label = np.asarray(batch[1][:valid])
        b_target = np.asarray(batch[2][:valid] if len(batch) > 2
                              else batch[1][:valid])
        all_adv.append(adv[:valid])
        all_label.append(b_label)
        all_target.append(b_target)
        success += int(succ[:valid].sum())
        total += valid
        computed += 1
        if args.resume:
            # atomic commit: a kill mid-write leaves no truncated shard
            tmp = shard_path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, adv=adv[:valid], label=b_label,
                         target=b_target, succ=succ[:valid], valid=valid)
            os.replace(tmp, shard_path)
        print(f"  [{args.attack}] {total} clouds done, "
              f"running success {success / max(total, 1):.3f}", flush=True)

    rate = success / max(total, 1)
    if stopped_early:
        print(f"stopped after {computed} new batches ({total} clouds in "
              f"shards); rerun with --resume to complete {out}")
        return None, rate

    save_npz(out, {
        "test_pc": np.concatenate(all_adv, 0),
        "test_label": np.concatenate(all_label, 0),
        "target_label": np.concatenate(all_target, 0),
    })
    MetricsWriter(out + ".metrics.jsonl").write(
        attack=args.attack, model=model_name, data=args.data,
        success_rate=rate, n=total, output=out)
    print(f"attack success rate {rate:.4f}; adversarial npz saved to {out}")
    if args.resume:
        shutil.rmtree(part_dir, ignore_errors=True)
    return out, rate


if __name__ == "__main__":
    main()
