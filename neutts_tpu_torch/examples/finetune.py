"""Finetune the speech LM (port of examples/finetune.py) with the port's
trainer, data-parallel over torch.distributed when started by torchrun (one
process per GPU, dp = world size; tensor parallelism waits for ROADMAP
Queue 1 item 6b).

The config YAML has the fields of examples/finetune_config.yaml. Dataset:
an HF dataset id with {"text", "codes"} columns (needs the `datasets`
package and a local cache) or "synthetic" / --synthetic for generated data.

    python -m neutts_tpu_torch.examples.finetune examples/finetune_config.yaml
    torchrun --nproc-per-node 4 -m neutts_tpu_torch.examples.finetune CONFIG.yaml
    python -m neutts_tpu_torch.examples.finetune CONFIG.yaml --synthetic --device cpu
"""

import argparse
import time
from pathlib import Path


def load_config(path):
    import yaml

    return yaml.safe_load(Path(path).read_text())


def synthetic_records(n, codebook, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    words = ["hello", "world", "voice", "model", "speech", "sound", "clone"]
    for _ in range(n):
        k = rng.integers(3, 8)
        text = " ".join(rng.choice(words, size=k)) + "."
        codes = rng.integers(0, codebook, size=int(k) * 12).tolist()
        yield {"text": text.capitalize(), "codes": codes}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Finetune the NeuTTS speech LM (PyTorch port)")
    ap.add_argument("config", nargs="?", default="examples/finetune_config.yaml")
    ap.add_argument("--synthetic", action="store_true", help="generated records")
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)
    cfg_file = load_config(args.config)

    from neutts_tpu_torch import config
    from neutts_tpu_torch.models import checkpoint as ckpt
    from neutts_tpu_torch.parallel import distributed as dist_lib
    from neutts_tpu_torch.text.g2p import get_g2p
    from neutts_tpu_torch.text.tokenizer import ByteTokenizer
    from neutts_tpu_torch.train import data as data_lib
    from neutts_tpu_torch.train import trainer

    cfg = config.BY_NAME[cfg_file.get("model", "tiny" if args.synthetic else "air")]
    tc = trainer.TrainConfig(
        learning_rate=float(cfg_file.get("learning_rate", 4e-5)),
        warmup_ratio=float(cfg_file.get("warmup_ratio", 0.05)),
        max_steps=int(cfg_file.get("max_steps", 1000)),
        seed=int(cfg_file.get("seed", 1337)),
    )
    max_seq_len = int(cfg_file.get("max_seq_len", cfg.max_context))
    batch_size = int(cfg_file.get("batch_size", 8))

    dist_lib.initialize(device=args.device)  # torchrun's environment, if any
    mesh = dist_lib.global_mesh(device=args.device)
    if batch_size % mesh.world_size:
        raise SystemExit(f"batch_size {batch_size} does not split over {mesh.world_size} ranks")
    restore = cfg_file.get("restore_from")
    if restore and Path(restore).exists():
        cfg, params, _, _ = ckpt.load_pipeline(restore, device=mesh.device)
        state = trainer.TrainState(params, trainer.make_optimizer(tc).init(params), 0)
        print(f"restored backbone from {restore}")
    else:
        state = trainer.init_state(cfg, tc, device=mesh.device)
        print(f"initialized {cfg.name} from scratch")

    tokenizer = ByteTokenizer(cfg.layout)
    g2p = get_g2p()
    if args.synthetic or cfg_file.get("dataset") in (None, "synthetic"):
        records = list(synthetic_records(int(cfg_file.get("n_samples", 256)),
                                         cfg.layout.codebook_size, tc.seed))
    else:
        from datasets import load_dataset

        ds = load_dataset(cfg_file["dataset"], split=cfg_file.get("split", "train"))
        records = ({"text": r["text"], "codes": list(r["codes"])} for r in ds)

    step_fn = trainer.make_sharded_train_step(cfg, tc, mesh)
    rows = dist_lib.process_batch_slice(mesh, batch_size)
    logging_steps = int(cfg_file.get("logging_steps", 10))
    step = 0
    t0 = time.time()
    while step < tc.max_steps:
        for batch in data_lib.batches(records, tokenizer, g2p, batch_size, max_seq_len):
            state, metrics = step_fn(state, *(dist_lib.host_local_batch(mesh, batch[k][rows])
                                              for k in ("tokens", "labels", "attn_mask")))
            step += 1
            if step % logging_steps == 0 and mesh.rank == 0:
                print(f"step {step}: loss {float(metrics['loss']):.4f} "
                      f"acc {float(metrics['accuracy']):.3f} "
                      f"({step/(time.time()-t0):.2f} steps/s)")
            if step >= tc.max_steps:
                break
        if not isinstance(records, list):
            break  # single pass over a streamed dataset

    if mesh.rank == 0:
        out = Path(cfg_file.get("checkpoints_dir", "checkpoints")) / "final"
        ckpt.save_params(out / "backbone.npz", state.params)
        print(f"saved weights to {out}/backbone.npz")
    dist_lib.shutdown()


if __name__ == "__main__":
    main()
