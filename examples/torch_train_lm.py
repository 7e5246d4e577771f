"""End-to-end training on the PyTorch/CUDA port: a ~100M-parameter LM, a
few hundred steps.

Builds a ~100M-param qwen3-family model, trains it on the synthetic bigram
stream with checkpointing and an injected mid-run failure (recovered
automatically), and prints the loss curve.  The same steps as
``examples/train_lm.py``, on the card by default.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
      [--tiny] [--device cpu]
(``--tiny`` uses the smoke size, which runs on the CPU in seconds.)

``main(mesh=...)`` trains on a built ``DeviceMesh`` of an initialised
world instead (each rank its shards, ``parallel.shard``); its ranks then
share ``ckpt_dir``.
"""
import argparse
import contextlib
import dataclasses
import tempfile

from repro_torch.configs import get_arch, plan_for_mesh, smoke_of
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import MeshSpec
from repro_torch.train import FailureInjector, OptConfig, Trainer, TrainerConfig


def main(device=None, steps: int = 300, tiny: bool = False, mesh=None,
         ckpt_dir: str | None = None) -> Trainer:
    base = get_arch("qwen3-0.6b")
    if tiny:
        arch = smoke_of(base)
        seq, batch = 64, 8
    else:
        # ~100M params: 12 layers, d_model 640, vocab 32k
        arch = dataclasses.replace(
            base, n_layers=12, d_model=640, n_heads=10, n_kv_heads=5,
            head_dim=64, d_ff=2048, vocab_size=32768, params_dtype="float32",
            compute_dtype="float32", name="qwen3-100m")
        seq, batch = 256, 8
    mesh = MeshSpec.local() if mesh is None else mesh
    plan = plan_for_mesh(mesh)
    print(f"arch={arch.name}: {arch.n_params():,} params")
    with contextlib.ExitStack() as stack:
        td = ckpt_dir or stack.enter_context(tempfile.TemporaryDirectory())
        tr = Trainer(
            arch, mesh, plan,
            DataConfig(vocab_size=arch.vocab_size, seq_len=seq,
                       global_batch=batch),
            OptConfig(peak_lr=6e-4, warmup_steps=steps // 10,
                      total_steps=steps),
            TrainerConfig(num_steps=steps, ckpt_every=max(steps // 4, 10),
                          ckpt_dir=td, log_every=max(steps // 15, 5)),
            injector=FailureInjector(fail_at=(steps // 2,)), device=device)
        tr.run()
    for h in tr.history:
        print(f"step {h['step']:4d}  loss {h['loss']:7.4f}  "
              f"gnorm {h['grad_norm']:7.3f}  lr {h['lr']:.2e}  "
              f"wall {h['wall']:7.1f}s")
    print(f"survived {tr.restarts} injected failure(s); "
          f"final loss {tr.history[-1]['loss']:.4f} "
          f"(vs {tr.history[0]['loss']:.4f} at start)")
    return tr


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default CUDA; 'cpu' runs on the CPU")
    a = ap.parse_args()
    main(device=a.device, steps=a.steps, tiny=a.tiny)
