"""Weight-streaming training on the GPU (the paper's Sec. III-A execution
mode): the PyTorch / CUDA port's counterpart of ``examples/weight_streaming.py``.

Parameters live in pinned host memory ("off-wafer DRAM"); each layer streams to
the card for the forward and again for the backward; its gradient streams back
and a host thread (the near-storage optimizer) updates the host weights.
Prints the losses, then the host-to-device and device-to-host rates the last
step measured, with the card's name, and what the paper's fabric models
(``repro_torch.core.fabric``, ``repro_torch.core.meshnet``) predict for this
loop's sustainable I/O rate on the modelled wafer (not on the card).

    PYTHONPATH=src python examples/torch_weight_streaming.py    # needs an NVIDIA GPU
"""

import sys

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.fabric import CONFIGS, FredFabric
from repro_torch.core.meshnet import MeshFabric
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ParallelConfig
from repro_torch.train.streaming import HostParams, stream_train_step


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_weight_streaming: this example needs an NVIDIA GPU "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    # head dim 64: the flash kernel's smallest
    cfg = get_config("llama3.2-1b").reduced(d_model=256, head_dim=64, num_layers=6,
                                            vocab_size=512)
    pcfg = ParallelConfig(remat="none")
    params = tfm.init(0, cfg, device="cuda")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64)))}
    with HostParams(params, cfg.num_layers) as hp:
        del params
        print("weight-streaming training (params resident in pinned host memory):")
        for step in range(8):
            loss = stream_train_step(hp, batch, cfg, pcfg, lr=5e-3)
            print(f"  step {step}: loss={loss:.4f}")
        s = hp.stats
    print(f"\nstream rates measured in the last step on {torch.cuda.get_device_name(0)}:")
    for way in ("h2d", "d2h"):
        print(f"  {way.upper()}: {s[f'{way}_bytes']} bytes in {s[f'{way}_s'] * 1e3:.3f} ms "
              f"({s[f'{way}_bytes'] / s[f'{way}_s'] / 1e9:.2f} GB/s)")
    print(f"  host update {s['update_s'] * 1e3:.3f} ms on {s['threads']} threads; "
          f"{s['slots']} device slot(s)")
    mesh, fred = MeshFabric(), FredFabric(CONFIGS["FRED-D"])
    print("\nfabric-model I/O analysis for this loop (paper Fig. 4; the modelled wafer):")
    print(f"  2D-mesh sustainable stream rate: "
          f"{mesh.io_stream_rate()/1e12:.2f} TB/s "
          f"(hotspot factor {mesh.io_linerate_factor():.2f})")
    print(f"  FRED sustainable stream rate:    "
          f"{fred.io_stream_rate()/1e12:.2f} TB/s (line rate)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
