"""Encoder pretraining curves of the JAX package and the port side by side,
on the CPU, from the same initial parameters and the same draws.

Both packages train the same reduced configuration; the port's chunks take
the JAX package's batch and augmentation draws (reconstructed from the JAX
key as tests/test_torch_pretrain.py does), so the two runs start from the
same bits and part only through rounding (bf16 convolutions in oneDNN
against XLA). Each chunk's mean of every loss term is printed for both, one
JSON line a chunk, then a summary line.

    JAX_PLATFORMS=cpu python scripts/pretrain_parity.py --steps 300 --chunk 50

The JAX package's step takes about 7 s on an 8-core CPU at 96 x 128 (its
bf16 convolutions), the port's about 0.3 s.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax
import jax.numpy as jnp
import numpy as np
import torch

import acezero_tpu.pretrain.encoder_pretrain as jep
from acezero_tpu.models.encoder import init_encoder_params as j_init_encoder
from acezero_tpu.models.head import HeadConfig as JHeadConfig
from acezero_tpu.training import optim as jopt
import acezero_tpu_torch.pretrain.encoder_pretrain as tep
from acezero_tpu_torch.models import torch_io as tio
from acezero_tpu_torch.models.head import HeadConfig
from acezero_tpu_torch.training import optim as topt
from test_torch_pretrain import _jax_draws, _np  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--num_scenes", type=int, default=2)
    ap.add_argument("--image_height", type=int, default=96)
    ap.add_argument("--image_width", type=int, default=128)
    ap.add_argument("--contrastive_weight", type=float, default=0.2)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)

    jcfg = jep.PretrainConfig(num_scenes=args.num_scenes, image_h=args.image_height, image_w=args.image_width,
                              steps=args.steps, chunk_steps=args.chunk, contrastive_weight=args.contrastive_weight)
    tcfg = tep.PretrainConfig(**jcfg.__dict__)
    corpus = tep.build_corpus(tcfg, workers=1)
    k_enc, k_heads, key = jax.random.split(jax.random.PRNGKey(jcfg.seed), 3)
    means = [jnp.asarray(m) for m in tep.scene_means(corpus, jcfg.num_scenes)]
    jparams = {"encoder": j_init_encoder(k_enc),
               "heads": jep._stack_heads(jax.random.split(k_heads, jcfg.num_scenes), JHeadConfig(0), means)}
    jstate = (jopt.adamw_init(jparams["encoder"]), jopt.adamw_init(jparams["heads"]))
    jdata = {k: jnp.asarray(corpus[k]) for k in
             ("images_u8", "coords", "w2c", "focals", "scene_ids", "c2w", "box_half", "occ_boxes")}
    enc, heads = tio.params_from_jax(_np(jparams["encoder"]), _np(jparams["heads"]))
    tparams = {"encoder": enc, "heads": heads}
    tstate = (topt.adamw_init(enc), topt.adamw_init(heads))
    tdata = tep.corpus_to_device(corpus, tcfg, "cpu")

    rows = []
    seconds = {"jax": 0.0, "torch": 0.0}
    for step in range(0, jcfg.steps, jcfg.chunk_steps):
        draws = _jax_draws(jcfg, key, jcfg.chunk_steps)
        t0 = time.perf_counter()
        jparams, jstate, key, jstats = jep._pretrain_chunk(jparams, jstate, jdata, key,
                                                           jnp.asarray(step, jnp.int32), jcfg, JHeadConfig(0))
        jmeans = {k: float(np.mean(np.asarray(v))) for k, v in jstats.items()}
        seconds["jax"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        tparams, tstate, tstats = tep.pretrain_chunk(tparams, tstate, tdata, step, tcfg, HeadConfig(0), draws=draws)
        tmeans = {k: float(v.mean()) for k, v in tstats.items()}
        seconds["torch"] += time.perf_counter() - t0
        row = {"steps": step + jcfg.chunk_steps, "jax": jmeans, "torch": tmeans, "seconds": dict(seconds)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"config": {k: getattr(jcfg, k) for k in ("num_scenes", "views_per_scene", "image_h", "image_w",
                                                         "batch_images", "steps", "chunk_steps",
                                                         "contrastive_weight")},
               "coord_l2_first_last": {p: [rows[0][p]["coord_l2"], rows[-1][p]["coord_l2"]] for p in ("jax", "torch")},
               "seconds": seconds}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
