"""Per-(arch x shape x mesh) parallelism presets (twin of
``repro.launch.presets``).

Chooses the Parallel knobs and sharding Rules for each cell:
  * FSDP (ZeRO-3) for train cells of archs with >= 8 B parameters;
  * EP where the expert count divides the "model" dim (granite: 32
    experts over 16); otherwise the experts' ffn goes over "model";
  * gradient-accumulation microbatches by d_model (8 from 6144, 4 from
    2048, else 2), at most the global batch over dp;
  * batch sharding off when the global batch is below dp (long_500k).

Pure: it reads the mesh's dim sizes only (a ``DeviceMesh`` or a stub
with ``shape`` by name and ``devices.size``), no process group.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed.sharding import Rules, rules_for_mesh
from repro_torch.launch.mesh import axis_size, mesh_devices
from repro_torch.models import model as M
from repro_torch.models.common import Parallel

FSDP_PARAM_THRESHOLD = 8e9


@dataclass(frozen=True)
class Preset:
    par: Parallel
    rules: Rules
    quantized_serving: bool = True    # serve cells with PTQ1.61 weights


def make_preset(cfg: ArchConfig, cell: ShapeCell, mesh) -> Preset:
    tp = axis_size(mesh, "model")
    dp = mesh_devices(mesh) // tp
    fsdp = bool(cell.kind == "train"
                and M.n_params(cfg) >= FSDP_PARAM_THRESHOLD)
    ep = bool(cfg.moe and cfg.moe.n_experts % tp == 0)
    shard_batch = cell.global_batch % dp == 0 and cell.global_batch >= dp
    if cell.kind == "train":
        micro = 8 if cfg.d_model >= 6144 else (4 if cfg.d_model >= 2048
                                               else 2)
        micro = min(micro, max(1, cell.global_batch // dp))
    else:
        micro = 1
    par = Parallel(tp=tp, dp=dp, fsdp=fsdp, sp=True, microbatches=micro,
                   remat=(cell.kind == "train"), attn_chunk=1024,
                   shard_batch=shard_batch, decode_unroll=False)
    return Preset(par=par, rules=rules_for_mesh(mesh, fsdp=fsdp, ep=ep))
