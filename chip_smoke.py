#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`sgdm_tpu_torch`) on one GPU.

    python3 chip_smoke.py                 # every phase, as below
    python3 chip_smoke.py --phases build,kernels --quick
    python3 chip_smoke.py --phases build,kernels --kernels self_attention,flash_attention
    python3 chip_smoke.py --phases build,profile   # device time by kernel

Phases (each one fails the run with a non-zero exit):
  1. build   the card's name and power limit, torch/CUDA versions, and the
             nvcc build of every kernel in sgdm_tpu_torch/csrc/;
  2. kernels each kernel against its plain PyTorch version on the card, in
             bf16, at every shape the model paths give it at model batch 128
             (sampling: 64 samples, CFG-doubled; training: batch 128): max
             abs error, kernel ms, plain ms and a library yardstick (cuDNN
             conv composition for the ResBlocks, forward and, for K5,
             forward+backward and, as library_bwd_ms, its backward alone;
             scaled_dot_product_attention for attention, with K/V expanded
             over the heads for K7; group_norm + FiLM + silu for K6;
             torch.optim.AdamW(fused=True) plus a foreach EMA for K8), and at
             odd shapes for correctness.  The attention forward rows (K3, K9
             fwd, K7) add device_ms: the kernel's and the library call's own
             device time under torch.profiler, in turns (kernel, library,
             library, kernel), the host's wrapper out of it, and so do K6's
             rows at its model shapes, where K6 also runs on its split
             route; then the ResBlock kernels' GN statistics kernel
             (gn_coef) alone at every (HW, C, dtype) of the IN64 serving and
             training paths;
  3. forward one full-width UNET_FAST_IN64 forward (cond_dim 1000, batch
             128, bf16, seeded random f32 weights) with kernels on and off;
  4. sample  the serving path: `generate(n=64, batch_size=64, steps=50,
             cond_scale=2)`, with the kernel launch counters set to 0 just
             before and read just after; its first 4 images written as PNGs
             by the serving code's stdlib writer and read back equal; plus a
             4-step kernels-on vs kernels-off sample of the same seed, held
             to SAMPLE_TOL, and the same sample with a faulty K1 (every
             output scaled by 1 + RESBLOCK_TOL), which must read above it.
  4b. samplers  every other sampler of the registry through phase 4's code
             (`generate(sampler=…)`, IN64 as in 4, B=64, cond_scale 2):
             native (100 forwards, on a 100-step linear schedule: the depth
             cut from 1000), plms (50 steps, 51 forwards), pndm (50:
             12 + 47), tero (50: 100), vdm (50 of its 250) and
             ddim_continuous (50), the
             last two on the cosine schedule; each a 4-image sample of few
             steps kernels on vs off and with K1 faulty, held to its own
             SAMPLE_TOL, then its default steps after a warm-up
             with exact launch counts (forwards, from the sampler's own
             timestep lists, × K1 17, K2 4, K3 6), seconds, images/s and
             forwards/s, 4 PNGs read back; then `generate(mask_dir=…)` on
             VOC64 (4 grey id-mask PNGs by the stdlib writer, 96 px resized
             to 64) held bit for bit against `generate(layout=…)` on the
             same arrays, 4 DDIM steps with exact counts (K1 17, K7 6 a step).
  5. train   the training path (`sgdm_tpu_torch.train.build`: the fused
             train step at model batch 128, cluster conditions, dropout 0.1,
             AdamW + EMA in K8) with seeded random nonzero weights: one step
             with kernels on and one with kernels off from the same state,
             draws and dropout seeds; then the counters set to 0, 2 warm-up
             and 8 timed steps, launch counts read just after.
  6. forward_ca, sample_ca, train_ca   the VOC64 `unetca_fast` family at full
             width (`UNETCA_FAST_VOC64`: stegoclusterlayout, 21 classes): one
             forward kernels on vs off; `generate(n=64, batch_size=64,
             steps=50, cond_scale=2)` with seeded uint8 layout id masks (the
             n-hot cond follows from each mask), counters set to 0 just
             before and read just after (K1 850, K7 300, K2 0, K3 0), and a
             4-step on-vs-off sample; one train step kernels on vs off from
             one state, then 1 warm-up and 4 timed steps at batch 128 with
             exact counts (per step K4 17, K5 17, K8 1, K9 0, K7 0).
  7. forward_b  the unfused ResBlock route through a model: IN64 `unet_fast`
             built with use_scale_shift_norm=False (21 unfused blocks: 42 K6
             launches per forward, K1 = K2 = 0, K3 6), one forward kernels on
             vs off, a 4-step guided sample of 64 images with exact counts
             and a 4-step on-vs-off sample; and one forward of the full-width
             model with a fourth level on 32-px input, whose 4-wide blocks
             fail the gate by width and run K6 with FiLM (K6 18, K1 15, K2 4,
             K3 6), kernels on vs off.
  8. fit     the trainer path (`python -m sgdm_tpu_torch.main --config
             sgdm_tpu_torch/configs/fit_in64_synthetic.json`: IN64 unet_fast,
             cond_dim 1000, batch 128, bf16, synthetic data, seeded random
             nonzero weights; 4 steps an epoch, 2 val batches, an image log
             of two 25-step EMA samples every 4 steps): a straight fit of 3
             epochs; a fit of 2 epochs and a fresh trainer resumed from
             ckpts/last for the third (start epoch and step exact, final
             params against the straight run's); a checkpoint save and
             restore held bit for bit (params, EMA, mu, nu, counts), with
             seconds and bytes; the bare train step on the same batches
             (the trainer's s/step over it); `generate --run` on the resumed
             run (64 images, 25 steps, EMA), 4 PNGs read back; the device
             idle share of 2 trainer steps (the 2-epoch fit runs with
             profile=1 and no image log) and of 2 bare steps under
             torch.profiler.  Launch counts exact in every run (per train step K4 17, K5 17, K9 6 +
             6, K8 0; per 25-step sampler call K1 425, K2 100, K3 150).
  8b. fit_in64p  the IN64 self-labeled run on its own data: a downsampled-
             ImageNet 64-px tree in Chrabaszcz's format written from the seed
             (ten train_data_batch_* of 1,024 images, a val_data of 2,048,
             labels 1..1000), a k = 5000 cluster h5 (train / val ids,
             centroids [5000, 768], an unallocated all_attributes carrying
             cluster_k) and its name2id .json written by the port's HDF5
             writer, the in64pickle.h5 pack written by the port's
             pickle_to_h5; get_batch on the pickle root, on the pack root and
             through __getitem__ + collate held bit for bit at batch 128, the
             native gather against its numpy version; get_batch images/s on
             each root and ConditionLookup.get µs a sample; then the CLI on
             sgdm_tpu_torch/configs/fit_in64p_cluster5000.json (the README's
             headline command: unet_fast, cond_dim 5000, cluster ids; batch
             128, bf16, seeded random nonzero weights) on the pack, cut in
             depth: 2 epochs of 8 steps, 2 val batches an epoch, one image
             log (8 images, 25 steps, cond_scale 2 and 0); the trainer's
             s/step over steps 2-8 of each epoch (CUDA events) against the
             bare make_train_step on the same batches; finite losses; launch
             counts exact (per train step K4 17, K5 17, K9 6 + 6; per
             sampling forward K1 17, K2 4, K3 6; K6-K8 0).
  8c. images  the JPEG decoder and PIL's resamplers on the card's host: each
             committed fixture (tests/fixtures/jpeg: grey, 4:4:4, 4:2:2,
             4:2:0, progressive, restart markers, odd sizes, Adobe CMYK, VOC
             and COCO sizes) decoded and held bit for bit against PIL's
             decode committed beside it; the native bilinear and bicubic
             resamplers, the datasets' one-call image chain and the PNG row
             unfilters bit for bit against their numpy versions; ms of a
             500x375 4:2:0 decode, a 640x480 one, the image chain (native
             and numpy) and a VOCSegmentation __getitem__; the train
             loader's images/s at batch 128 with 4, 8 and 16 threads;
             os.cpu_count().
  8d. fit_voc64_lost  the README's VOC64 self-boxed run (sgdm_tpu_torch/
             configs/fit_voc64_lost.json: unetca_fast, clusterlayout with
             LOST boxes, cond_dim 100; batch 128, bf16, seeded random
             nonzero weights) through the CLI on a written VOC tree: 1,024
             train and 256 val names over the 4 VOC-size fixtures (each file
             decoded per sample), 16 distinct id masks by the stdlib PNG
             writer, a k = 100 cluster h5 keyed by image name and a LOST h5
             (a box and a cluster id a name) by the port's HDF5 writer; 2
             epochs of 8 steps, 2 val batches an epoch, one image log (8
             images, 25 steps, cond_scale 2 and 0); the reader's images/s
             (the train loader at the config's 16 threads, batches 2 and on)
             against the 128 / s_step the step consumes; the trainer's s/step
             over the bare make_train_step on the same batches, by epoch;
             then `generate --run` (16 images, 25 steps, boxes and cluster
             ids).  Launch counts exact (per train step K4 17, K5 17; per
             sampling forward K1 17, K7 6; K2, K3, K6, K8, K9 0).
  8e. fit_coco64_stego  the README's COCO-Stuff64 self-segmented run
             (configs/fit_coco64_stego.json: stegoclusterlayout, k = 27) on a
             written COCO-Stuff tree: 512 train and 128 val names over the
             640x480 and the grey 480x640 fixture, fine-id annotations
             (182 → 27 by a written fine_to_coarse_dict.pickle) and STEGO
             masks; 1 epoch of 4 steps, 1 val batch, no image log; measured
             and asserted as 8d.
  8f. feat_in64p  the README's feature extraction (`python -m
             sgdm_tpu_torch.selfsup.feat_extractor --feat dino_vitb16 --ds
             in64p --bs 256 --image_size 64`, through the CLI's main) on
             8b's written tree (10,240 + 2,048 images, the pack), with a
             seeded full-width ViT-B/16 state dict saved in torch.hub DINO's
             format as dino_vitbase16_pretrain.pth under SGDM_SSL_CKPT_DIR:
             seconds and images/s of the CLI, transform + encode alone per
             batch of 256 (CUDA events) against its f32 bound; the h5 read
             back (shapes, labels, string attrs, the .json); the first 16
             CLS rows against the port's CPU forward of the same weights
             (FEAT_TOL), and read once more with TF32 on, which must
             exceed it; --spatial --attn and --tencrop on SyntheticImages'
             512 + 128 for shapes.  The path has no hand-written kernel: its
             launch counts must read 0.
  8g. cluster_in64p  the README's cluster command (--k 5000 --niter 10
             --nns 20) on 8f's file, read back by ConditionLookup; then
             run_kmeans at IN64 scale in memory (seeded mixture features made
             on the card: 1,281,167 train + 50,000 val rows, d 768, k 5000,
             10 iterations): s per Lloyd iteration against its bound, the
             objective per iteration (no rise beyond KM_OBJ_TOL), clusters
             split, 65,536 assignments against a float64 argmin on the host
             (a mismatch only where the float64 top-2 gap is below KM_GAP);
             knn_search of 8,192 queries against the 1.33 M rows: seconds,
             peak memory (at most the index, one MAX_BYTES distance split
             and 1 GiB), one chunk's ms by CUDA events against its bound,
             the memory one split's products, its topk and a [rows, N] tie
             count by `sum` add, 64 queries against float64 brute force
             (KNN_TOL).
  8h. lost_voc64  the LOST CLI (`python -m sgdm_tpu_torch.selfsup.lost --ds
             voc64 --root <tree> --cluster_k 100`, through its main) on a
             written VOC tree (1,024 train names, 8d's writer) with a seeded
             ViT-S/16 dino_deitsmall16_pretrain.pth: images/s, every box
             inside its 300-px img4unsup, the file read back by LostLookup;
             run_lost on the first LOST_TIMED images against the JAX
             package's loop of one image at a time, and their reads alone;
             the first 8 boxes against the port's CPU run of the same
             weights and draws (an unequal box must come with degree counts
             that differ: a similarity on the other side of 0).
  8i. stego_coco64  STEGO at the published COCO-Stuff widths (ViT-S/8 with
             a seeded dino_deitsmall8_pretrain.pth under SGDM_SSL_CKPT_DIR,
             code 70, 27 clusters, 224 px, batch 16, kNN 7, feature_samples
             11, neg_samples 5) on a written COCO-Stuff tree (512 train
             names, 8e's writer, img4unsup at the config's 320 px):
             precompute_knns and 20 train_stego steps (ms a step every 10,
             finite losses); the trained head saved as a
             LitUnsupervisedSegmenter .ckpt; the mask CLI (`python -m
             sgdm_tpu_torch.selfsup.stego`, through its main) on 2 val JPEGs
             (640x480 and 480x640): ms an image of the network at native
             resolution (4,800 tokens) and s an image of the host CRF, each
             against its size, then once more with --no_crf, and with
             --no_crf on the seeded random head (no --ckpt: masks of several
             ids); the log-probs of one whole image and a 320x240 crop of
             another card against CPU (STEGO_LP_TOL), read once more with
             TF32 on, which must exceed it; the whole image's three CLI
             masks against the CPU's (the CRF on the CPU log-probs, then the
             argmax; the CRF's probabilities card vs CPU within
             STEGO_CRF_TOL) up to near-ties (a top-2 gap at most twice the
             card's error; at most STEGO_TIE_SHARE of the pixels); both mask
             dirs read back through CocoStuffDataset with stego_dir set, each
             n-hot that of its one-hot and within the ids of the file.  No
             hand-written kernel: launch counts read 0.
  8j. backbones  every non-ViT name of get_ssl_backbone at full width from a
             seeded checkpoint written in its loader's format (rn50:
             torchvision with fc; simclr_rn50: pl_bolts encoder.;
             vissl_deepclusterv2: SwAV module.; vissl_jigsaw and vissl_simclr
             (ResNet-101): VISSL consolidated; dino_xcit_m24_p8:
             facebookresearch XCiT): images/s of transform_batch +
             batch_encode_feat at batch 256, 224 px (CUDA events) against the
             f32 bound of its FLOPs; 16 rows (XCiT: 4) card against CPU
             (BACKBONE_TOL), read once more with TF32 on, which must exceed
             it.  Launch counts 0.
  8k. cluster_pca_in64p  (run before 8g, which removes 8f's tree)
             clustering_pca (4 views) and clustering_ensemble (4
             members) on 8f's feat h5, k 100, niter 30: the host PCA's
             seconds and each view's / member's, the [N, 4] int64 matrices'
             shapes and every id in [0, k).  Launch counts 0.
  9. fid     the FID path at full width (the FID InceptionV3 at 299, the
             port's seeded random network; IN64 unet_fast): the card's two
             resizes and the network's pool3 / logits / spatial on 16
             seeded 64-px images against the same module on the CPU (full
             f32; the TF32 drift printed beside); extractor images/s at
             batch 64 per resize; PNG decode ms an image per row filter and
             over the reference dir; the CLI with validation FID (1 epoch
             of FIT_CONFIG against 1,024 reference PNGs: the oracle FID,
             then one validation FID of 128 samples of 25 DDIM steps, the
             tenth of val_fid_num 1,280 that epoch 0 takes, both in the
             trainer's debug mode (clean FID, sFID, PRDC), the best
             checkpoint), then the test phase restored from ckpts/last (128
             samples of 25 steps at cond_scale 0, every metric,
             test_results.json) with the IN64 paper figures on (vis.random,
             samecondition, interp, kmeans_vis, cluster_hist_vis, chainvis,
             condscale, knn, tsne: each PNG's shape, each figure's seconds,
             the chain and the guidance sweep in the launch counts); kNN and
             t-SNE timed again at 2,000 points (1,000 a dir);
             every FID call, sample dir and sqrtm timed; `python -m
             sgdm_tpu_torch.eval.fid_cli --debug` on the reference dir and
             the last samples (a subprocess run beside phase parallel).  Launch counts exact
             (per sampling forward K1 17, K2 4, K3 6).
  10. parallel  training across ranks (sgdm_tpu_torch/parallel): world 1
             over NCCL in this process, the IN64 DDP step (batch 128, dropout
             0.1, K8) bit for bit against the bare step with exact launch
             counts (K4 17, K5 17, K9 6 + 6, K8 1), the FSDP step against
             the bare step on FSDP's route (einsum attention: K9 0), ms a
             step, NCCL's all-reduce of the 297 MB gradient on one rank;
             then min(cards, 4) ranks over NCCL, or two ranks sharing one
             card over gloo: 2 DDP steps at global batch 128 against world 1
             (losses, the first gradient, every parameter within its bound;
             the ranks' parameters bit-equal), FSDP's per-rank state bytes,
             TP at (ranks / 2, 2) on the plain route against world 1 on that
             route, ms a step; then `python -m sgdm_tpu_torch.main` at
             pl.trainer.devices=2 on FIT_CONFIG for one epoch (with phase
             fid asked for, started before it and run beside it): one
             checkpoint from rank 0 restored at world 1 bit for bit, the
             _rank0 / _rank1 validation sample dirs, and the FID of the
             ranks' reduced statistics against one process's.
  11. classifier  the noisy-image classifier (`EncoderUNetModel` at its
             defaults: 64 px, 1000 classes, batch 128, f32), each pool from
             seeded random nonzero weights: the loss, every gradient and
             the eval logits kernels on vs off from one state and draw
             (TF32 off on both sides, CLS_* limits); the step's bound from
             its operations (FlopCounterMode's convolutions at the TF32
             peak, the rest and K9 at the f32 peak); 2 warm-up + 8 timed
             train steps with exact launch counts (K9 f32 3 + 3 a step,
             nothing else), the per-noise-level accuracy table on 2 val
             batches (K9 f32 3 a forward), the msgpack checkpoint written
             and read back equal; then the CLI (`--arch full`, 8 steps and
             20 eval forwards) with the counters at 0 just before and read
             just after.  K9's f32 kernel rows (phase 2) hold it against
             its plain version at [128, 8, 256, 64] and at odd shapes, two
             backward runs bit for bit, with device time beside SDPA's f32
             kernels in turns and each kernel's ptxas report (no spills).
  12. data7c  item 7c on the card's host: a Cityscapes tree of 2048x1024
             PNGs (row filters 0-4) and a COCO 2014 tree of the VOC-size
             JPEG fixtures with polygon instances, each read by its dataset
             through the loader at 16 threads, batch 128 (images/s against
             phase train's step), one sample's keys and shapes checked;
             `imagenet_downsample resize` on 256 JPEGs, images/s.
  13. vdiff  v-diffusion serving (`sgdm_tpu_torch.diffusion.vdiff_cli`) at
             cc12m_1_cfg's full width (256 px, cs 128-1024, 4 blocks a
             level, 602.9 M parameters, f32, TF32 off): seeded random
             weights written to a .pth in the published keys; one forward
             at batch 1 on the card against the port's own on the CPU
             (VDIFF_TOL, and the TF32 reading that must exceed it), ms per
             forward at batch 1 and 8 beside the bound (FlopCounterMode's
             FLOPs at the f32 peak, the weights and every convolution's and
             linear's input and output at HBM rate); then through the CLI's
             main() from that .pth: cfg-sample (--embed at weight 3, so
             CFG batches of 2n; -n 4, plms, 15 steps: wall and sampling
             seconds, forwards/s, images/s, the 4 PNGs read back),
             clip-sample (cc12m_1, the native ViT-B/16 CLIP on seeded
             weights, ddim, 5 steps, 16 cutouts, -cs 500: seconds a guided
             step, peak memory, the image against an unguided run of the
             same seed), modify-image (plms, 6 steps) and make-grid (the
             grid read back equals its tiles), the K1-K9 counters 0 over
             all four (nothing of this path reaches a TPU kernel).
  14. ssl_pretrain  the SSL pre-trainers (`sgdm_tpu_torch.selfsup`) at full
             width, f32 with TF32 off, each through its CLI's main() on
             synthetic data: MAE pre-training of ViT-B/16 at 224
             (`mae_vit_base_patch16`: encoder 768/12/12, decoder 512/8/16,
             mask 0.75, batch 64, SSL_MAE_STEPS steps) ending in the
             encoder's .msgpack export; MSN of ViT-S/16 (384/12/6: one anchor
             view at 224, 10 focal views at 96, 1024 prototypes, patch drop
             0.15, batch 32, SSL_MSN_STEPS steps); the export read back by
             get_ssl_backbone("mae_vitb16", ckpt_path=…) (features against
             the trained encoder's, SSL_FEAT_TOL), logistic_eval and
             linear_probe on its features of SSL_PROBE_ROWS images; MAE
             fine-tuning of ViT-B/16 at 224 from that export (drop-path 0.1,
             mixup 0.8, cutmix 1.0, smoothing 0.1, layer decay 0.65, 1000
             classes, RandAugment and random erasing on, batch 64,
             SSL_FT_STEPS steps and one eval batch).  For each trainer: one
             step on the card against the same step on the CPU from the same
             weights and fed draws at batch SSL_CPU_BATCH (the loss within
             SSL_LOSS_TOL relative, and the TF32 reading that must exceed it;
             the parameters after the update: the share off by more than
             1e-3·lr within SSL_PARAM_SHARE), ms a step (median of the timed
             steps; the first step counts FLOPs under FlopCounterMode) beside
             its bound (those FLOPs at the f32 peak), the host dataset's
             images/s beside the step's, peak memory; the K1-K9 counters 0
             over the whole phase (no kernel is on this path).
  15. vis_voc64  the VOC64 paper figures: the test phase
             (`eval.harness.run_test_and_all_exploration`) of a VOC64
             `unetca_fast` trainer (fit_voc64_lost.json, seeded random
             weights, cond_scale 2) on 64-px `SyntheticSegImages` (seeded
             STEGO masks and LOST boxes), 64 samples of VIS_VOC_STEPS DDIM
             steps a scale, with stego_chainvis, lost_chainvis,
             random_stego_with_mask and random_lost_with_box on; the FIDs
             stubbed (phase 9 measures them); each PNG's shape, launch
             counts exact (K1 17, K7 6 a forward).
  16. zoo    the Imagen / LDM-codec / VQ zoo (f32, TF32 off): `BaseUnet64`
             at its preset (dim 512, mults 1-4, 3 blocks, attention at three
             levels, text 256 × 2048), its parameter count,
             forward_with_cond_scale at batch 2 (CFG batch 4) ms, card vs
             CPU at batch 1 (ZOO_TOL); the kl-f8 first stage (ch 128, mults
             1, 2, 4, 4, 2 blocks, z 4, 256 px) encode and decode at batch 4
             ms, card vs CPU on the first image; VectorQuantize(256, 512)
             ZOO_VQ_STEPS train steps, ms a step, the EMA state card vs CPU.
  17. wrn    the WRN validator's CLI (`python -m
             sgdm_tpu_torch.data.wrn_validate -s 64`, its defaults: n 4, k
             1, batch 128 flip-doubled, 1000 classes) on written 64-px
             pickles (WRN_PER_FILE rows in each of 10 train files): one
             epoch with its eval and checkpoint, then resumed for a second;
             ms a step; one step card vs CPU from the same weights (the loss
             within WRN_LOSS_TOL, the update within WRN_UPDATE_TOL).
  (profile, only when asked for: torch.profiler over a 4-step sample at the
             served shape and over 2 train steps, for IN64, for VOC64 and,
             sampling only, for the unfused model: device busy share and
             device time by kernel; and over one `SelfAttentionBlock` at the
             IN64 shape, its sampling route and its training route (forward
             and backward), as they run now and with the q, k, v, output (and
             dO, dq, dk, dv) copies they made before the kernels took strides,
             every kernel by name.)
Every phase prints its results as JSON lines and, once done, its wall
seconds ({"phase_done": ...}); then come the script's seconds with each
phase's ({"chip_smoke": ...}), one JSON line {"kernels": [...]}, the
nvidia-smi line, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time

from sgdm_tpu_torch.utils import parity_runbook, profiling, roofline, trace_summary
from sgdm_tpu_torch.utils.profiling import cuda_time, device_ms, device_ms_in_turns
from sgdm_tpu_torch.utils.roofline import F32_FLOP_PER_S, HBM_BYTES_PER_S, TF32_FLOP_PER_S, \
    bound_ms
from sgdm_tpu_torch.utils.trace_summary import profile_rows, trace_idle

KERNEL_ITERS = 5              # timed calls a kernel row (depth cuts from 20, 10)
SAMPLE_N = 64                 # images served per `generate` call
MODEL_BATCH = 2 * SAMPLE_N    # doubled by the fused CFG pass
# (H, W, Cin, Cout, calls per UNet forward) of every ResBlock the IN64
# unet_fast forward sends to K1, and (H_in, C, resample) for K2
K1_SHAPES = [
    (64, 64, 128, 128, 2), (64, 64, 384, 128, 1), (64, 64, 256, 128, 2),
    (32, 32, 128, 256, 1), (32, 32, 256, 256, 1), (32, 32, 768, 256, 1),
    (32, 32, 512, 256, 1), (32, 32, 384, 256, 1), (16, 16, 256, 512, 1),
    (16, 16, 512, 512, 3), (16, 16, 1024, 512, 2), (16, 16, 768, 512, 1),
]
K2_SHAPES = [(64, 128, "down"), (32, 256, "down"), (16, 512, "up"), (32, 256, "up")]
K3_SHAPE = (MODEL_BATCH, 8, 256, 64)
K3_CALLS = 6
# Tolerances (max abs error of the bf16 output, relative to max|plain|):
# both sides round h1/h3 to bf16 and the output to bf16 at the same points;
# they differ in f32 summation order (GN statistics, conv accumulation),
# which can flip a bf16 rounding of h1/h3 and moves the output by a few bf16
# ulps (2^-8 relative each).
RESBLOCK_TOL = 2.0 ** -5
# f32 logits and softmax on both sides; bf16 weights and output.  With one chunk
# of keys (N <= 256 at D <= 64, N <= 128 at D = 128) the kernels round the
# weights where the plain versions do (normalise in f32, then cast).  Beyond
# (K7's M = 273, N = 1024, ...) they carry the row maximum and sum over the key
# chunks, round the UNNORMALISED weights to bf16 and divide by the sum last: a
# few bf16 ulps (2^-9 relative each) of the weights, averaged over the row.
ATTENTION_TOL = 2.0 ** -6
FORWARD_TOL = 5e-2          # 27 kernel calls of bf16 flips, relative to max|eps|
# Mean |uint8 difference| of a 4-image 4-step sample (native: on 8
# timesteps), kernels on vs off, by sampler: eps differs by the forward's
# bf16 flips (under 1 % of max|eps|), and each sampler carries that to the
# image its own way (DDIM's x0 = (x - sqrt(1-a)·eps)/sqrt(a) amplifies it by
# about 4 at t = 751; VDM divides by alpha near 0).  Each limit sits between
# the sound reading and the reading with every K1/K2 output scaled by
# 1 + RESBLOCK_TOL, a fault as large as the kernel check lets through
# (NVIDIA H100 80GB HBM3, 700.00 W: sound / faulty DDIM 2.02 / 11.62,
# native 0.13 / 2.06, plms 2.91 / 15.41, pndm 0.29 / 3.86, tero 0.41 / 4.11,
# vdm 1.83 / 8.27, ddim_continuous 1.30 / 7.65; VOC64 DDIM 2.70 / 21.32).
# Both readings are repeatable bit for bit; `phase_sample` prints both and
# fails unless the faulty one lies above the limit.
SAMPLE_TOL = {"ddim": 4.0, "native": 0.5, "plms": 4.0, "pndm": 1.0, "tero": 1.0, "vdm": 4.0,
              "ddim_continuous": 3.0}
# Training path (batch 128).  K4 keeps K1's rounding points (and the same
# bit-exact dropout hash), so its output and residuals take K1's tolerance.
# K5: every gradient's max abs error relative to max|plain gradient|; both
# sides round g, h1, h3d and dh2 to bf16 for the gradient convolutions, so
# f32 summation-order flips of those roundings move each gradient by a few
# bf16 ulps of its scale, as for K1.
TRAIN_BATCH = 128
DROPOUT, DROPOUT_SEED = 0.1, 1234
K5_TOL = 2.0 ** -5
K9_SHAPE = (TRAIN_BATCH, 8, 256, 64)
K9_CALLS = 6
# K9 forward is K3's arithmetic; its backward rounds P and dS to bf16 on both
# sides, so the gradients differ by bf16 flips (2^-8 relative each).
K9_TOL = 2.0 ** -6
# K8 and its plain version round every operation once, in the same order
# (IEEE division and square root): they agree bit for bit (measured 0); the
# limit allows two f32 ulps.
K8_TOL = 2.0 ** -22
N_PARAMS_IN64 = 74_252_803
# K7 at the VOC64 unetca_fast shape: q [B, N, H, D] against k, v [B, M, D],
# M = 16 context + 1 null + 256 self keys; 6 calls per UNet forward.  Its
# rounding points are K3's (f32 logits and softmax, bf16 weights, f32
# accumulation, one cast), so it takes K3's tolerance.
K7_SHAPE = (MODEL_BATCH, 256, 8, 64, 273)
K7_CALLS = 6
# K6: the output is the bf16 rounding of an f32 chain on both sides (kernel
# and plain differ in f32 rounding of expf and the operation order inside
# silu only), so they differ by at most a flip of the last bf16 bit: 2^-8
# relative, held to two ulps of max|plain|.
K6_TOL = 2.0 ** -7
# Train step, kernels on vs off from the same state (a state at count 500,
# past the lr warmup, so lr = 1e-4 and the step moves the parameters): the
# forward differs by bf16 flips through 21 ResBlocks and 6 attentions (under
# 1 % of max|eps|), the backward by the same through twice the depth.
TRAIN_LOSS_TOL = 2e-2       # |loss_on - loss_off| / loss_off
TRAIN_GRAD_COS = 0.99       # cosine of the flattened gradients, at least
TRAIN_LEAF_TOL = 0.25       # worst leaf: max|g_on - g_off| / max|g_off|
# Parameters after the update: from zero moments at count 500, Adam moves an
# element by at most adam_step_bound() (≈1.99·lr, plus the decay term), so
# two runs whose gradient signs differ somewhere end at most twice that
# apart, and neither run's update may exceed it (K8 on one side, its plain
# version on the other).
TRAIN_LR, TRAIN_WD, TRAIN_COUNT = 1e-4, 0.01, 500


def adam_step_bound(max_abs_param: float) -> float:
    """Largest |Δp| of one AdamW step from zero moments at TRAIN_COUNT."""
    t = TRAIN_COUNT + 1
    ratio = 0.1 / (1 - 0.9 ** t) / math.sqrt(0.001 / (1 - 0.999 ** t))
    return TRAIN_LR * (ratio + TRAIN_WD * max_abs_param) * (1 + 1e-3)
TRAIN_STEPS_WARMUP, TRAIN_STEPS_TIMED = 2, 8
# the tooling on the main paths (utils/roofline.py, trace_summary.py,
# parity_runbook.py): the train-step audit traces 2 steps after its accounting
# step; the sample audit one call of 4 DDIM steps (a depth cut from 50); a
# kernel row above 105 % of its bound miscounts its work.  Their seconds go
# to TOOLING_SECONDS (phase_seconds' tooling_* keys)
ROOFLINE_TRAIN_STEPS, ROOFLINE_SAMPLE_STEPS, ROOFLINE_SHARE_MAX = 2, 4, 1.05
FIT_TRACED_STEPS = 2          # the steps of each of phase fit's traces (steps 2-3 of an epoch)
# the runbook's cluster stage: a feat h5 of RUNBOOK_ROWS train (RUNBOOK_VAL
# val) rows of RUNBOOK_DIM features around RUNBOOK_K seeded class centres
RUNBOOK_ROWS, RUNBOOK_VAL, RUNBOOK_DIM, RUNBOOK_K = 10_240, 1_024, 768, 100
TOOLING_SECONDS: dict[str, float] = {}
# per train step of IN64 unet_fast: 17 same-resolution ResBlocks (K4, K5),
# 6 attentions at 16x16 (K9), one fused update of the flat parameter buffer (K8)
TRAIN_LAUNCHES = {"resblock_train": 17, "resblock_bwd": 17, "flash_attention_fwd": K9_CALLS,
                  "flash_attention_bwd": K9_CALLS, "adamw_ema": 1}
# VOC64 unetca_fast: 17 same-resolution ResBlocks (no up/down ResBlock: its
# resampling is plain strided / nearest convs) and 6 AttentionLR blocks
CA_SAMPLE_LAUNCHES = {"resblock": 17, "null_kv_attention": K7_CALLS}
CA_TRAIN_LAUNCHES = {"resblock_train": 17, "resblock_bwd": 17, "adamw_ema": 1}
CA_TRAIN_STEPS_WARMUP, CA_TRAIN_STEPS_TIMED = 1, 4
# phase samplers: every sampler of the registry but DDIM (phase sample's) on
# the IN64 serving path, each at its default steps; vdm and ddim_continuous on
# the cosine schedule (their closed-form log-SNR), the others on the linear
# one; per model forward K1 17, K2 4, K3 6.  MASK_DIR_* : the --mask-dir check
# on VOC64 (4 grey id masks at 96 px, resized to 64, ids < 21 and 255).
SAMPLERS = ("native", "plms", "pndm", "tero", "vdm", "ddim_continuous")
NATIVE_T = 100                # native's timesteps (the depth cut from 1000)
VDM_STEPS = 50                # vdm's steps (the depth cut from its default 250)
MASK_DIR_FILES, MASK_DIR_PX, MASK_DIR_STEPS = 4, 96, 4
# Path B, per forward: the unfused IN64 model, and the 4-level model on 32 px
B_LAUNCHES = {"groupnorm_silu": 42, "self_attention": K3_CALLS}
B_WIDTH_LAUNCHES = {"groupnorm_silu": 18, "resblock": 15, "resblock_resample": 4,
                    "self_attention": 6}
B_SAMPLE_STEPS = 4
# The trainer path (phase fit): the config the port CLI runs, composed from
# data=synthetic32 dynamic=unet_fast at IN64 width (tests/test_torch_config.py
# recomposes it); 4 steps an epoch, an image log of FIT_IMAGELOG_CALLS guided
# EMA samples (cond_scale 2 and 0; vis.samecondition and vis.interp are off)
# of FIT_IMAGELOG_STEPS DDIM steps every FIT_VIS_EVERY steps, FIT_VAL_BATCHES
# val batches an epoch
FIT_CONFIG = "sgdm_tpu_torch/configs/fit_in64_synthetic.json"
FIT_EPOCHS, FIT_STEPS_PER_EPOCH, FIT_VIS_EVERY, FIT_VAL_BATCHES = 3, 4, 4, 2
FIT_IMAGELOG_CALLS, FIT_IMAGELOG_STEPS = 2, 25   # (a depth cut from 50)
# The IN64 self-labeled run on its own data (phase fit_in64p): the README's
# headline config (tests/test_torch_config.py recomposes it), on a written
# downsampled-ImageNet tree of IN64P_TRAIN_FILES x IN64P_PER_FILE train and
# IN64P_VAL val images, a k = IN64P_K cluster h5 with IN64P_FEAT-wide
# centroids; IN64P_EPOCHS epochs of IN64P_STEPS steps, IN64P_VAL_BATCHES val
# batches an epoch, one image log at the last step
IN64P_CONFIG = "sgdm_tpu_torch/configs/fit_in64p_cluster5000.json"
IN64P_TRAIN_FILES, IN64P_PER_FILE, IN64P_VAL = 10, 1024, 2048
IN64P_K, IN64P_FEAT, IN64P_CLASSES = 5000, 768, 1000
IN64P_EPOCHS, IN64P_STEPS, IN64P_VAL_BATCHES = 2, 8, 2
IN64P_TIMED_BATCHES = 20      # get_batch calls timed on each root, after one warm-up
# The segmentation runs on their own data (phases images, fit_voc64_lost,
# fit_coco64_stego): the committed JPEG fixtures (tests/fixtures/jpeg, each
# with PIL's decode beside it as a PNG) and the README's VOC64 self-boxed and
# COCO-Stuff64 self-segmented configs (tests/test_torch_config.py recomposes
# them), on written trees: VOC_TRAIN + VOC_VAL names over the 4 VOC-size
# fixtures with VOC_MASKS distinct id masks, a k = VOC_K cluster h5 and a
# LOST h5; COCO_TRAIN + COCO_VAL names over the 2 COCO-size fixtures
JPEG_FIXTURES = "tests/fixtures/jpeg"
VOC_CONFIG = "sgdm_tpu_torch/configs/fit_voc64_lost.json"
COCO_CONFIG = "sgdm_tpu_torch/configs/fit_coco64_stego.json"
VOC_FIXTURES = ("voc_500x375_a", "voc_500x375_b", "voc_375x500_a", "voc_375x500_b")
COCO_FIXTURES = ("coco_640x480", "coco_480x640_grey")
VOC_TRAIN, VOC_VAL, VOC_MASKS, VOC_K = 1024, 256, 16, 100
VOC_EPOCHS, VOC_STEPS, VOC_VAL_BATCHES = 2, 8, 2
COCO_TRAIN, COCO_VAL, COCO_K = 512, 128, 27
COCO_EPOCHS, COCO_STEPS, COCO_VAL_BATCHES = 1, 4, 1
# phases 8f-8h: the self-labeling path on the card, f32 with TF32 off
FEAT_BATCH = 256              # the README's --bs
FEAT_SEED, LOST_SEED = 13, 14  # the seeded DINO-format state dicts
FEAT_CPU_ROWS = 8             # CLS rows held against the port's CPU forward (cut from 16)
FEAT_TOL = 5e-5               # max |card − CPU| of those rows (LayerNorm outputs, O(1));
                              # the same rows with TF32 on must read above it
FEAT_TIMED_BATCHES = 4        # transform + encode batches timed alone, by CUDA events (cut from 8)
FEAT_SHAPES_N = 512           # --spatial --attn and --tencrop on SyntheticImages' 512
FEAT_HEADS = 12               # ViT-B's
KM_TRAIN, KM_VAL, KM_DIM, KM_K, KM_ITERS = 1_281_167, 50_000, 768, 5000, 10   # (10: a depth cut from the README's 30)
KM_MIX, KM_NOISE = 1000, 0.5  # the features: 1000 Gaussian components, unit centres
KM_CHECK, KM_GAP = 65_536, 1e-4   # rows held against float64; the top-2 gap that excuses
KM_OBJ_TOL = 1e-6             # the objective may rise by this much relative, no more
KNN_QUERIES, KNN_K, KNN_CHECK = 8192, 21, 64
KNN_TOL = 1e-5                # |d² − float64 d²| / max float64 d² of the query's k
LOST_BOX_CHECK = 8            # boxes held against the port's CPU run
LOST_TIMED = 64               # images timed batched, one at a time, and read alone (depth cuts from 256, 128)
SEG_GENERATE_N = 16           # generate --run on the VOC run: images, 50 steps
READER_BATCHES = 6            # loader batches timed, after the first
IMAGES_TIMED = 10             # decodes and __getitem__ calls timed per row (a depth cut from 20)
READER_THREADS = (8, 16)      # loader threads of phase images' reader rows (4 cut)
# phases 8i-8k: the rest of self-annotation, f32 with TF32 off.  STEGO at the
# published COCO-Stuff widths (ViT-S/8, code 70, 27 clusters, 224 px, batch
# 16, kNN 7, feature_samples 11, neg_samples 5) on COCO_TRAIN images; the
# mask CLI on STEGO_MASK_IMAGES val JPEGs (the CRF on the host takes seconds
# an image); log-probs card vs CPU on one whole image and a crop of
# STEGO_CPU_CROP of another; the whole image's masks against the CPU's up to
# near-ties: pixels whose top-2 gap is at most twice the card's error
STEGO_SEED, STEGO_DIM, STEGO_BATCH, STEGO_KNN = 15, 70, 16, 7
STEGO_STEPS, STEGO_LOG_EVERY = 10, 5      # (depth cuts from 20, 10)
STEGO_SIZE4CLUSTER = 320      # configs/data/cocostuff64.yaml
STEGO_MASK_IMAGES = 2
STEGO_CPU_CROP = (240, 320)
STEGO_LP_TOL = 1e-5           # max |card − CPU| of the log-probs (α = 2, |values| ≤ 8)
STEGO_CRF_TOL = 1e-5          # max |card − CPU| of the CRF's probabilities (on the CPU a
                              # log-prob change of 1e-5 moves them by 8.4e-7)
STEGO_TIE_SHARE = 0.01        # near-ties allowed in a mask, as tests/test_torch_stego.py
COCO_TRAIN2017 = 118_287      # images in COCO's train2017, for the CRF's projection
BACKBONES = ("rn50", "simclr_rn50", "vissl_deepclusterv2", "vissl_jigsaw", "vissl_simclr",
             "dino_xcit_m24_p8")
BACKBONE_BATCH, BACKBONE_TIMED = 256, 2    # (2: a depth cut from 3)
BACKBONE_CPU_ROWS = dict({n: 8 for n in BACKBONES}, dino_xcit_m24_p8=4)   # (8: cut from 16)
BACKBONE_TOL = 1e-5           # max |card − CPU| / max(1, max |CPU|) of the features; the
                              # same rows with TF32 on must read above it
PCA_K, PCA_NITER, PCA_VIEWS = 100, 30, 4
# The FID path (phase fid): the extractor on the card against the same module
# on the CPU on FID_IMAGES seeded 64-px images, both in full f32 (TF32 off).
# The resizes are one formula on both devices, but the antialiased bicubic
# computes its weights and sums differently on each (9.0e-4 apart on the
# 0-255 scale on the H100): held to the limit the CPU tests hold the CPU's
# against PIL's (tests/test_torch_inception.py BICUBIC_TOL).  The network's
# outputs differ by f32 summation order only.
FID_IMAGES, FID_BATCH = 16, 64
RESIZE_TOL = 2e-3             # max |Δ| on the 0-255 scale
INCEPTION_TOL = 1e-4          # max|Δ| / max|CPU| of pool3, logits and spatial
# the CLI with validation FID: FID_EPOCHS epoch of FIT_CONFIG against a
# reference dir of FID_REF_N images, one validation FID (the oracle's first)
# of a tenth of FID_VAL_NUM samples (the trainer's epoch-0 fraction: 128) of
# FID_VAL_STEPS DDIM steps; then the test phase restored from
# ckpts/last with FID_TEST_NUM samples of FID_TEST_STEPS steps per cond scale
FID_REF_N, FID_VAL_NUM, FID_EPOCHS = 1024, 1280, 1   # (1280: a depth cut from 2560)
FID_TEST_NUM, FID_VAL_STEPS, FID_TEST_STEPS = 128, 25, 25   # (depth cuts from 50, 50)
# Training across ranks (phase parallel).  World 1 over NCCL in this process,
# then par_world() ranks: PAR_STEPS DDP steps at global batch TRAIN_BATCH
# against world 1.  Both sides draw the same t, noise, condition drops and
# dropout masks; they differ in the rounding of the kernels' batch-tiled
# sums (K5's weight gradients over 64 samples a rank, then the all-reduce):
# the first gradient's cosine at least PAR_GRAD_COS and its largest
# difference at most PAR_GRAD_REL of its largest element (read 1.66e-4 on 2
# gloo ranks and 2.50e-4 on 4 cards), losses within PAR_LOSS_TOL (read
# 1.2e-5 and 1.9e-5); after the first step Adam moves an element whose
# gradient sign the order flips by its bound the other way, so every
# parameter is held to twice Adam's bound a step (a sanity bound only: any
# two Adam runs from one start meet it).  FSDP PAR_FSDP_STEPS steps on its
# route against world 1's.  TP at PAR_TP_BATCH, one step, against world 1
# on its route, the same loss and cosine limits (its row split sums partial
# products over the ranks: read 4.3e-5 to 6.9e-5 of the loss, cosine
# 0.999994), and its largest gradient difference at most PAR_TP_GRAD_REL
# (each rank rounds its partial sums to bf16 before the all-reduce: read
# 1.27e-3 on 2 gloo ranks).  Controls,
# which must fail those limits: the DDP step with every rank's dropout masks
# taken from row 0 (the offset left out), the gradient of an all-reduce that
# sums instead of averaging (the cosine cannot see it), and the TP step with
# the ResBlocks' dropout left out.
# The CLI at devices=2: PAR_FID_VAL_NUM (its tenth, PAR_FID_SAMPLES, at
# epoch 0) samples against PAR_FID_REF reference images; the logged FID
# against one process's statistics of both ranks' dirs (PAR_FID_TOL: float64
# sums in another order).
PAR_WORLD_MAX, PAR_RANK_TIMEOUT = 4, 600
PAR_STEPS, PAR_FSDP_STEPS, PAR_TP_BATCH = 2, 2, 8   # (depth cuts from 3, 3)
PAR_LOSS_TOL, PAR_GRAD_COS, PAR_GRAD_REL, PAR_TP_GRAD_REL = 1e-4, 0.9999, 1e-3, 5e-3
PAR_ALLREDUCE_ITERS = 5
PAR_FID_REF, PAR_FID_VAL_NUM, PAR_FID_SAMPLES, PAR_FID_TOL = 64, 160, 16, 1e-6
# The noisy-image classifier (phase classifier): `EncoderUNetModel` at its
# defaults (model_channels 128, channel_mult (1, 2, 4), two res blocks a
# level, attention at ds 4 with 8 heads) on 64 px, 1000 classes, batch 128,
# f32, both pools, T = 1000.  Its three attention blocks sit at 16x16 (N 256,
# 512 channels, head dim 64), where the flash gate passes: per train step
# K9 on f32 operands 3 forwards + 3 backwards, per eval forward 3 forwards;
# its ResBlocks are the composition (K1-K6 0) and its update the plain
# optax-order AdamW (K8 0).  Kernels on vs off from one state and draws,
# under full f32 (TF32 off on both sides): only K9's FFMA order against the
# plain version's matmuls differs, f32 rounding through 11 ResBlocks.
CLS_BATCH, CLS_PX, CLS_CLASSES, CLS_T, CLS_K9 = 128, 64, 1000, 1000, 3
CLS_STEPS_WARMUP, CLS_STEPS_TIMED = 2, 8
CLS_VAL_BATCHES, CLS_LOG_STEPS = 2, 10
CLS_CLI_DATA = 1024           # the CLI's --data-len: 8 train steps, 2 val batches
CLS_LOSS_TOL = 1e-5           # |loss_on − loss_off| / loss_off
CLS_GRAD_COS = 0.99999        # cosine of the flattened gradients, at least
CLS_LEAF_TOL = 1e-3           # worst leaf: max|g_on − g_off| / max|g_off|
CLS_LOGIT_TOL = 1e-4          # eval logits on vs off: max|Δ| / max|off|
# K9 on f32 operands against its plain version (f32 matmuls, TF32 off): both
# exact f32, apart in summation order and exp rounding (read ~1e-6)
K9_F32_SHAPE = (CLS_BATCH, 8, 256, 64)
K9_F32_TOL = 1e-4
# Item 7c's readers and CLIs on the card's host (phase data7c): a Cityscapes
# tree of 2048x1024 RGB PNGs (CS_DISTINCT distinct, row filters cycling
# 0-4, each hard-linked under many names) with 34-id labelIds PNGs; a COCO
# 2014 tree of the VOC-size JPEG fixtures with COCO7C_POLYS polygon
# instances an image (plus a crowd one); each read by its dataset through
# the train loader at DATA7C_THREADS threads (the configs' num_workers),
# batch 128, images/s over DATA7C_BATCHES batches after the first (the page
# cache warm: hard links); then `imagenet_downsample resize` (box, 64 px) on
# RESIZE_FILES JPEG fixtures, images/s on one thread as the CLI runs
CS_TRAIN, CS_VAL, CS_DISTINCT, CS_SIZE = 640, 16, 8, (1024, 2048)
COCO7C_TRAIN, COCO7C_VAL, COCO7C_POLYS = 640, 16, 6
DATA7C_THREADS, DATA7C_BATCHES = 16, 2    # (a depth cut from 4 batches)
RESIZE_FILES = 256
# v-diffusion serving (phase vdiff): cc12m_1_cfg at full width from seeded
# random f32 weights.  Card against CPU, both f32 with TF32 off: cuDNN's and
# oneDNN's summation orders through 100-odd convolutions (read ~1e-6 of
# max|v|); TF32 on reads far above the limit.
VDIFF_MODEL, VDIFF_SEED = "cc12m_1_cfg", 0
VDIFF_TOL = 1e-4              # max|card − CPU| / max|CPU| of v at batch 1
VDIFF_TIMED = (1, 2, 8)       # forward batches timed (2: the CLI's default CFG batch)
VDIFF_CFG_N, VDIFF_CFG_STEPS = 4, 15          # cfg-sample: images, plms steps (depth cuts: 50, 25)
VDIFF_CFG_FORWARDS = 3 * 4 + (VDIFF_CFG_STEPS - 3)   # 3 PRK warm-up steps, then one a step
VDIFF_CLIP_STEPS, VDIFF_CUTN, VDIFF_CS = 5, 16, 500   # clip-sample: ddim steps (cut from 10), cutouts, scale
VDIFF_MODIFY_STEPS = 6        # (depth cuts from 20, 10)
# SSL pre-training (phase ssl_pretrain): the trainers' full widths, cut in
# depth (steps, dataset length, probe rows), never in width
SSL_MAE_ARGS = ("--input-size", "224", "--patch-size", "16", "--embed-dim", "768", "--depth",
                "12", "--num-heads", "12", "--decoder-dim", "512", "--decoder-depth", "8",
                "--decoder-heads", "16", "--mask-ratio", "0.75")
SSL_MSN_ARGS = ("--patch-size", "16", "--embed-dim", "384", "--depth", "12", "--num-heads", "6",
                "--rand-size", "224", "--focal-size", "96", "--rand-views", "1", "--focal-views",
                "10", "--num-proto", "1024", "--patch-drop", "0.15")
SSL_FT_ARGS = ("--input_size", "224", "--patch_size", "16", "--embed_dim", "768", "--depth", "12",
               "--num_heads", "12", "--drop_path", "0.1", "--mixup", "0.8", "--cutmix", "1.0",
               "--smoothing", "0.1", "--layer_decay", "0.65", "--nb_classes", "1000")
SSL_MAE_BATCH, SSL_MAE_STEPS = 64, 3      # the first step counts FLOPs, the rest are timed (cut from 4)
SSL_MSN_BATCH, SSL_MSN_STEPS = 32, 3     # (cut from 4)
SSL_FT_BATCH, SSL_FT_STEPS = 64, 3
SSL_WORKERS = 8               # loader threads (the card's host has 8 cores)
SSL_CPU_BATCH = 2             # card-vs-CPU step batch
SSL_CMP_LR = 1e-4             # the constant lr of the card-vs-CPU step
# |loss card − loss CPU| / |loss CPU| of one step: both f32 (TF32 off), apart
# in summation order only (≈1e-7 an op through 12-20 blocks); TF32 on moves a
# matmul by ≈1e-3 and must read above it.  After one Adam update a parameter
# moves by ≈lr whatever its gradient's size, so only gradients at float32's
# noise floor (the key bias's, 0 in exact arithmetic) may differ, in sign
SSL_LOSS_TOL = 1e-6           # read 0-7.4e-8 on the card; TF32 on 6.3e-6-2.9e-5
SSL_PARAM_SHARE = 1e-3        # share of parameters off by more than 1e-3·lr after one update
SSL_FEAT_TOL = 1e-5           # max |export's features − trained encoder's| (the same weights)

# the IN64 paper figures on the fid phase's test call; kNN and t-SNE again at
# 2 × VIS_POINTS points
VIS_IN64 = ("random", "samecondition", "interp", "kmeans_vis", "cluster_hist_vis", "chainvis",
            "condscale", "knn", "tsne")
VIS_POINTS = 1000
# the VOC64 figures: a test phase of VIS_VOC_N samples of VIS_VOC_STEPS steps
VIS_VOC = ("stego_chainvis", "lost_chainvis", "random_stego_with_mask", "random_lost_with_box")
VIS_VOC_N, VIS_VOC_STEPS, VIS_VOC_CLUSTERS = 64, 20, 100
# the zoo: card vs CPU, max|card − CPU| / max|CPU| (f32, TF32 off)
ZOO_TOL = 1e-4
ZOO_TEXT = (256, 2048)        # BaseUnet64's text tokens: the module's defaults
ZOO_VQ_SHAPE, ZOO_VQ_STEPS = (8, 1024, 256), 5
# the WRN validator: rows a train pickle (10 files, flip-doubled: 8 steps of
# 128 a file), val rows; one step card vs CPU: the loss and the whole update
# (‖Δcard − Δcpu‖ / ‖Δcpu‖), relative
# (the update of a fresh net with near-uniform outputs sums cancelling terms
# through 13 BatchNorms: it read 8.3e-4 card vs CPU with TF32 off, the loss
# 6.8e-8)
WRN_PER_FILE, WRN_VAL, WRN_LOSS_TOL, WRN_UPDATE_TOL = 512, 1000, 1e-6, 1e-2
WRN_CPU_BATCH = 32            # the card-vs-CPU step's batch
SSL_PROBE_ROWS, SSL_PROBE_TEST = 2048, 512   # 64-px images, resized to 224 on the card
# K6's kernels by name (csrc/groupnorm.cu): the cluster route, the split route's two
K6_KERNELS = ("gn_cluster_kernel", "gn_split_stats_kernel", "gn_split_apply_kernel")
# kernel -> (source, the TPU kernel it replaces)
META = {
    "resblock": ("sgdm_tpu_torch/csrc/resblock.cu", "sgdm_tpu/ops/pallas/resblock.py:153"),
    "resblock_resample": ("sgdm_tpu_torch/csrc/resblock.cu",
                          "sgdm_tpu/ops/pallas/resblock.py:211"),
    "self_attention": ("sgdm_tpu_torch/csrc/attention.cu", "sgdm_tpu/ops/pallas/attention.py:33"),
    "resblock_train": ("sgdm_tpu_torch/csrc/resblock.cu", "sgdm_tpu/ops/pallas/resblock.py:479"),
    "resblock_bwd": ("sgdm_tpu_torch/csrc/resblock_bwd.cu",
                     "sgdm_tpu/ops/pallas/resblock.py:260"),
    "flash_attention_fwd": ("sgdm_tpu_torch/csrc/attention.cu", "sgdm_tpu/models/layers.py:428"),
    "flash_attention_bwd": ("sgdm_tpu_torch/csrc/attention.cu", "sgdm_tpu/models/layers.py:428"),
    "flash_attention_fwd_f32": ("sgdm_tpu_torch/csrc/attention_f32.cuh",
                                "sgdm_tpu/models/layers.py:428"),
    "flash_attention_bwd_f32": ("sgdm_tpu_torch/csrc/attention_f32.cuh",
                                "sgdm_tpu/models/layers.py:428"),
    "adamw_ema": ("sgdm_tpu_torch/csrc/fused_optim.cu", "sgdm_tpu/ops/pallas/fused_optim.py:50"),
    "groupnorm_silu": ("sgdm_tpu_torch/csrc/groupnorm.cu", "sgdm_tpu/ops/pallas/groupnorm.py:33"),
    "null_kv_attention": ("sgdm_tpu_torch/csrc/null_kv_attention.cu",
                          "sgdm_tpu/ops/pallas/attention.py:100"),
}


def k6_shapes() -> dict:
    """(H, W, C) -> calls per forward of the IN64 unet_fast model built with
    use_scale_shift_norm=False: every ResBlock is the unfused composition, whose
    in_norm sees the block's input and whose out_norm sees conv1's output."""
    calls: dict = {}
    for h, w, cin, cout, n in K1_SHAPES:
        for key in ((h, w, cin), (h, w, cout)):
            calls[key] = calls.get(key, 0) + n
    for h, c, resample in K2_SHAPES:
        ho = h // 2 if resample == "down" else 2 * h
        for key in ((h, h, c), (ho, ho, c)):
            calls[key] = calls.get(key, 0) + 1
    assert sum(calls.values()) == 42
    return calls


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_usage(stem: str, kernel: str) -> dict:
    """Registers and spills of every entry function of ``csrc/<stem>.cu`` whose
    (mangled) name holds ``kernel``, from nvcc's ``-Xptxas -v`` report kept
    beside the built library (``build/kernels/<hash>/<stem>.log``)."""
    import re

    from sgdm_tpu_torch.ops import build

    found, name = {}, None
    for line in (build._build_dir() / f"{stem}.log").read_text().splitlines():
        m = re.search(r"wgmma.mma_async instructions are serialized.*'(\w+)'", line)
        if m and kernel in m.group(1):  # ptxas waits after every product of that function
            found.setdefault(m.group(1), {})["wgmma_serialized"] = True
            continue
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            found.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                              spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.setdefault(name, {})["registers"] = int(m.group(1))
    return found


@contextlib.contextmanager
def k1_fault(gain: float):
    """A faulty K1/K2: every fused ResBlock output of the UNet scaled by
    1 + ``gain``, for the kernels on/off check to show that it can fail."""
    from sgdm_tpu_torch.models import layers

    real = layers.fused_resblock
    layers.fused_resblock = lambda *a, **k: real(*a, **k) * (1 + gain)
    try:
        yield
    finally:
        layers.fused_resblock = real


@contextlib.contextmanager
def full_f32():
    """The plain side runs f32 convolutions and products without TF32."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------- phase 2

def resblock_operands(gen, h, w, cin, cout, dev, b=MODEL_BATCH):
    import torch

    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    x = r(b, h, w, cin).to(torch.bfloat16)
    ops = dict(
        gn1_scale=1 + 0.1 * r(cin), gn1_bias=0.1 * r(cin),
        w1=r(3, 3, cin, cout) / math.sqrt(9 * cin), b1=0.1 * r(cout),
        film_scale=(0.1 * r(b, cout)).to(torch.bfloat16),
        film_shift=(0.1 * r(b, cout)).to(torch.bfloat16),
        gn2_scale=1 + 0.1 * r(cout), gn2_bias=0.1 * r(cout),
        w2=r(3, 3, cout, cout) / math.sqrt(9 * cout), b2=0.1 * r(cout),
    )
    if cin != cout:
        ops["skip_w"] = r(1, 1, cin, cout) / math.sqrt(cin)
        ops["skip_b"] = 0.1 * r(cout)
    return x, ops


def library_resblock(x, o, resample=None):
    """cuDNN yardstick: the same block as bf16 NCHW/channels_last PyTorch ops."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    cin, cout = x.shape[-1], o["w1"].shape[-1]
    xc = x.permute(0, 3, 1, 2)
    h = F.silu(F.group_norm(xc.float(), math.gcd(32, cin), o["gn1_scale"], o["gn1_bias"],
                            1e-5)).to(bf)
    skip = xc
    if resample == "down":
        h, skip = F.avg_pool2d(h, 2), F.avg_pool2d(xc, 2)
    elif resample == "up":
        h, skip = (F.interpolate(t, scale_factor=2, mode="nearest") for t in (h, xc))
    h = F.conv2d(h, o["w1"].permute(3, 2, 0, 1).to(bf), o["b1"].to(bf), padding=1)
    h = F.group_norm(h.float(), math.gcd(32, cout), o["gn2_scale"], o["gn2_bias"], 1e-5)
    h = F.silu(h * (1 + o["film_scale"].float()[:, :, None, None])
               + o["film_shift"].float()[:, :, None, None]).to(bf)
    h = F.conv2d(h, o["w2"].permute(3, 2, 0, 1).to(bf), o["b2"].to(bf), padding=1)
    if "skip_w" in o:
        skip = F.conv2d(xc, o["skip_w"].permute(3, 2, 0, 1).to(bf), o["skip_b"].to(bf))
    return (skip + h).permute(0, 2, 3, 1)


def rel_err(a, b) -> float:
    """max|a - b| / max|b| (0 when b is all zero and a equals it)."""
    scale = b.float().abs().max().item()
    diff = (a.float() - b.float()).abs().max().item()
    return diff / scale if scale > 0 else diff


def library_resblock_grad(x, o, dout):
    """cuDNN yardstick of K4+K5: the composition's forward and backward (autograd)."""
    import torch

    xs = x.detach().requires_grad_()
    leaves = {k: v.detach().requires_grad_() for k, v in o.items()}
    out = library_resblock(xs, leaves)
    return torch.autograd.grad(out, [xs, *leaves.values()], dout)


def library_resblock_bwd(x, o, dout):
    """cuDNN yardstick of K5 alone: the composition's forward is run once here,
    outside the timed calls; each call of the returned function is its
    autograd backward (the graph kept)."""
    import torch

    xs = x.detach().requires_grad_()
    leaves = {k: v.detach().requires_grad_() for k, v in o.items()}
    out = library_resblock(xs, leaves)
    inputs = [xs, *leaves.values()]
    return lambda: torch.autograd.grad(out, inputs, dout, retain_graph=True)


def check_kernel(fn, plain, library, iters):
    import torch

    with full_f32():
        ref = plain()
    out = fn()
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype, (out.shape, ref.shape)
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ms = cuda_time(fn, iters)
    with full_f32():
        plain_ms = cuda_time(plain, max(1, iters // 2), warmup=1)
    library_ms = cuda_time(library, iters) if library is not None else None
    return err, scale, ms, plain_ms, library_ms


def null_kv_rows(dev, gen, iters, add) -> None:
    """K7 at the VOC64 shape, then correctness at odd shapes: head dims that
    are not multiples of 8 (21, 28), N = 1024 with D = 32 and M = 1041 (K/V
    streamed), M = 256 (one chunk), 257 and 280 (a second chunk of 1 and of
    24 keys), N = 17 with D = 128, one key.  M = 273 is two key chunks joined
    by the online rescale (unnormalised weights rounded to bf16, the row sum
    divided out last): a few bf16 ulps of the weights away from the plain
    version's order, inside ATTENTION_TOL."""
    import torch
    import torch.nn.functional as F

    from sgdm_tpu_torch.ops import attention as att

    def operands(b, n, h, d, m):
        q = (torch.randn(b, n, h, d, generator=gen, device=dev) * d ** -0.5).to(torch.bfloat16)
        k, v = (torch.randn(b, m, d, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        return q, k, v

    b, n, h, d, m = K7_SHAPE
    q, k, v = operands(*K7_SHAPE)

    def library():
        kk, vv = (t[:, None].expand(b, h, m, d) for t in (k, v))
        return F.scaled_dot_product_attention(q.permute(0, 2, 1, 3), kk, vv,
                                              scale=1.0).permute(0, 2, 1, 3)

    err, scale, ms, pms, lms = check_kernel(
        lambda: att.null_kv_attention_cuda(q, k, v),
        lambda: att.null_kv_attention_plain(q, k, v), library, iters)
    bnd, by = roofline.null_kv_cost(b, n, h, d, m).bound()
    dev_t = device_ms_in_turns(lambda: att.null_kv_attention_cuda(q, k, v), library, iters)
    row = dict(kernel="null_kv_attention", shape=list(K7_SHAPE), calls=K7_CALLS,
               max_abs_err=err, max_abs_ref=scale, ms=ms, plain_ms=pms, library_ms=lms,
               bound_ms=bnd, bound_by=by, **dev_t,
               blocks_per_sm=att.forward_blocks_per_sm(m, d, null_kv=True))
    print(json.dumps(row), flush=True)
    assert err <= ATTENTION_TOL * max(scale, 1.0), f"K7: err {err}"
    add("null_kv_attention", K7_CALLS, err, ms, pms, lms, bnd, by, dev_t)
    rows = []
    for shape in [(3, 49, 32, 21, 66), (2, 64, 32, 28, 81), (2, 1024, 8, 32, 1041),
                  (2, 256, 8, 64, 257), (1, 17, 3, 128, 34), (2, 5, 1, 8, 1),
                  (2, 256, 8, 64, 256), (2, 256, 8, 64, 280)]:
        q, k, v = operands(*shape)
        out = att.null_kv_attention_cuda(q, k, v)
        with full_f32():
            ref = att.null_kv_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        rows.append(dict(kernel="null_kv_attention", shape=list(shape), max_abs_err=err,
                         max_abs_ref=scale))
        assert torch.isfinite(out.float()).all() and err <= ATTENTION_TOL * max(scale, 1.0), \
            rows[-1]
    print(json.dumps({"odd_shapes": rows}), flush=True)


def groupnorm_rows(dev, gen, iters, add) -> None:
    """K6 at every (H, W, C) the unfused IN64 model gives it at model batch
    128, without FiLM (what that model runs; counted per forward) and with
    FiLM (what a block whose gate fails by width runs), on the route its plan
    picks; then once more on the split route (``calls`` 0, so the sums per
    forward stay the planned route's); two calls bit-identical; then odd
    shapes on both routes."""
    import torch
    import torch.nn.functional as F

    from sgdm_tpu_torch.ops import groupnorm as gn

    def operands(b, h, w, c, film):
        r = lambda *s: torch.randn(*s, generator=gen, device=dev)
        x = (1.5 * r(b, h, w, c) + 0.5).to(torch.bfloat16)
        fs, fsh = ((0.1 * r(b, c)).to(torch.bfloat16) for _ in range(2)) if film else (None, None)
        return x, 1 + 0.1 * r(c), 0.1 * r(c), fs, fsh

    def library(x, g, bt, fs, fsh):
        h = F.group_norm(x.permute(0, 3, 1, 2), math.gcd(32, x.shape[-1]),
                         g.to(x.dtype), bt.to(x.dtype), 1e-5)
        if fs is not None:
            h = h * (1 + fs[:, :, None, None]) + fsh[:, :, None, None]
        return F.silu(h).permute(0, 2, 3, 1)

    def plan_of(b, h, w, c, route=None):
        return gn.device_plan(dev.index or 0, b, h * w, c, math.gcd(32, c), route)

    def resident(plan, c):  # clusters the card holds at once (cudaOccupancyMaxActiveClusters)
        return gn._lib().sgdm_groupnorm_max_clusters(int(c % 8 == 0), plan.cluster,
                                                     plan.threads, plan.smem)

    for (h, w, c), calls in sorted(k6_shapes().items()):
        groups = math.gcd(32, c)
        for film in (False, True):
            ops = operands(MODEL_BATCH, h, w, c, film)
            bnd, by = roofline.groupnorm_cost(MODEL_BATCH, h, w, c, film).bound()
            for route in (None, "split"):
                plan = plan_of(MODEL_BATCH, h, w, c, route)
                fn = lambda: gn.groupnorm_silu_cuda(*ops, groups, route=route)
                err, scale, ms, pms, lms = check_kernel(
                    fn, lambda: gn.groupnorm_silu_plain(*ops, groups), lambda: library(*ops),
                    iters)
                same = bool(torch.equal(fn(), fn()))
                row = dict(kernel="groupnorm_silu", shape=[MODEL_BATCH, h, w, c], film=film,
                           route=plan.route, cluster=plan.cluster,
                           blocks_per_sm=plan.blocks_per_sm, smem=plan.smem,
                           resident_clusters=resident(plan, c) if plan.cluster else None,
                           grid_clusters=plan.grid,
                           calls=calls if route is None and not film else 0, max_abs_err=err,
                           max_abs_ref=scale, ms=ms, plain_ms=pms, library_ms=lms,
                           bound_ms=bnd, bound_by=by, bit_identical=same)
                dev_t = None
                if route is None and not film:
                    dev_t = device_ms_in_turns(fn, lambda: library(*ops), iters)
                    row.update(dev_t)
                print(json.dumps(row), flush=True)
                assert err <= K6_TOL * max(scale, 1.0), \
                    f"K6 {row['shape']} film={film} {plan.route}: err {err}"
                assert same, f"K6 {row['shape']} film={film} {plan.route}: two calls differ"
                add("groupnorm_silu", row["calls"], err, ms, pms, lms, bnd, by, dev_t)
    rows = []
    for b, h, w, c in [(3, 4, 4, 20), (2, 5, 7, 36), (2, 1, 16, 24), (1, 3, 3, 7)]:
        for film in (False, True):
            ops = operands(b, h, w, c, film)
            ref = gn.groupnorm_silu_plain(*ops, math.gcd(32, c))
            for route in ("cluster", "split"):
                out = gn.groupnorm_silu_cuda(*ops, math.gcd(32, c), route=route)
                again = gn.groupnorm_silu_cuda(*ops, math.gcd(32, c), route=route)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                rows.append(dict(kernel="groupnorm_silu", shape=[b, h, w, c], film=film,
                                 route=route, cluster=plan_of(b, h, w, c, route).cluster,
                                 max_abs_err=err, max_abs_ref=scale,
                                 bit_identical=bool(torch.equal(out, again))))
                assert torch.isfinite(out.float()).all() and err <= K6_TOL * max(scale, 1.0) \
                    and rows[-1]["bit_identical"], rows[-1]
    # x not 16-byte aligned (a view one element in): the cluster route copies
    # the run with ordinary loads, the split route's wrapper copies x
    c = 41 * 8
    flat = (1.5 * torch.randn(1 + 5 * 7 * c, generator=gen, device=dev) + 0.5).bfloat16()
    x = flat[1:].view(1, 5, 7, c)
    _, g, bt, _, _ = operands(1, 1, 1, c, False)
    for route in ("cluster", "split"):
        out = gn.groupnorm_silu_cuda(x, g, bt, None, None, 8, route=route)
        ref = gn.groupnorm_silu_plain(x, g, bt, None, None, 8)
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        rows.append(dict(kernel="groupnorm_silu", shape=list(x.shape), misaligned=True,
                         route=route, max_abs_err=err, max_abs_ref=scale))
        assert torch.isfinite(out.float()).all() and err <= K6_TOL * max(scale, 1.0), rows[-1]
    print(json.dumps({"odd_shapes": rows}), flush=True)


def gn_coef_shapes() -> dict:
    """(HW, C, dtype) -> [calls per IN64 DDIM step, calls per IN64 train step]
    of the ResBlock kernels' GN-statistics kernel (`sgdm_gn_coef`): GN1 on x
    (bf16) and GN2 on h2 (f32) of every K1/K2 call of a sampling forward, and
    of every K4 call of a train step (K1's shapes; the up/down blocks train
    as a cuDNN composition)."""
    calls: dict = {}

    def add(key, step, n):
        calls.setdefault(key, [0, 0])[step] += n

    for h, w, cin, cout, n in K1_SHAPES:
        for step in (0, 1):
            add((h * w, cin, "bf16"), step, n)
            add((h * w, cout, "f32"), step, n)
    for h, c, resample in K2_SHAPES:
        ho = h // 2 if resample == "down" else 2 * h
        add((h * h, c, "bf16"), 0, 1)
        add((ho * ho, c, "f32"), 0, 1)
    return calls


def gn_coef_rows(dev, gen, iters) -> None:
    """`gn_coef_kernel` alone (the statistics step inside K1, K2 and K4: one
    block a sample) at every (HW, C, dtype) of the IN64 serving and training
    paths, batch 128: ms a call and a step, and a bytes bound (x read once,
    the [B, 3, C] coefficients written)."""
    import ctypes

    import torch

    from sgdm_tpu_torch.ops import resblock as rb

    lib = rb._lib()
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    tot = dict(gn_coef_ms_per_sample_step=0.0, gn_coef_ms_per_train_step=0.0,
               bound_ms_per_sample_step=0.0)
    for (hw, c, dt), (n_sample, n_train) in sorted(gn_coef_shapes().items()):
        b = MODEL_BATCH
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = (1.5 * torch.randn(b, hw, 1, c, generator=gen, device=dev) + 0.5).to(dtype)
        g = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
        bt = 0.1 * torch.randn(c, generator=gen, device=dev)
        coef = torch.empty(b, 3, c, device=dev)

        def run():
            err = lib.sgdm_gn_coef(rb._ptr(x), int(dt == "f32"), b, hw, c, math.gcd(32, c),
                                   1e-5, rb._ptr(g), rb._ptr(bt), None, None, rb._ptr(coef),
                                   None, stream())
            assert err == 0, f"gn_coef: CUDA error {err}"

        ms = cuda_time(run, iters)
        bnd, _ = bound_ms(b * hw * c * x.element_size() + b * 3 * c * 4, 0.0)
        row = dict(kernel="gn_coef", hw=hw, c=c, dtype=dt, batch=b, calls_sample_step=n_sample,
                   calls_train_step=n_train, ms=ms, bound_ms=bnd, bound_by="bytes",
                   ms_per_sample_step=n_sample * ms, ms_per_train_step=n_train * ms)
        tot["gn_coef_ms_per_sample_step"] += n_sample * ms
        tot["gn_coef_ms_per_train_step"] += n_train * ms
        tot["bound_ms_per_sample_step"] += n_sample * bnd
        print(json.dumps(row), flush=True)
    print(json.dumps({"gn_coef": tot}), flush=True)


def phase_kernels(dev, iters: int, only: set | None = None) -> dict:
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    agg = {k: dict(err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, by={})
           for k in META}

    def add(kernel, calls, err, ms, plain_ms, lib_ms, bnd, by, dev_t=None, lib_bwd_ms=None):
        a = agg[kernel]
        if dev_t is not None:  # per step, like ms
            for key in ("device_ms", "library_device_ms"):
                a[key] = a.get(key, 0.0) + calls * dev_t[key]
        if lib_bwd_ms is not None:
            a["library_bwd_ms"] = a.get("library_bwd_ms", 0.0) + calls * lib_bwd_ms
        a["seen"] = True
        a["err"] = max(a["err"], err)
        a["ms"] += calls * ms
        a["plain_ms"] += calls * plain_ms
        a["library_ms"] += calls * lib_ms
        a["bound_ms"] += calls * bnd
        a["by"][by] = a["by"].get(by, 0.0) + calls * bnd

    # the attention forward kernels take tens of microseconds: five times the calls
    if only is None or "null_kv_attention" in only:
        null_kv_rows(dev, gen, 5 * iters, add)
    if only is None or "groupnorm_silu" in only:
        groupnorm_rows(dev, gen, iters, add)
        gn_coef_rows(dev, gen, iters)
    if only is not None:
        if "resblock" in only:
            resblock_rows(dev, gen, iters, add)
            check_odd_shapes(dev, gen)
            check_k5_odd_shapes(dev, gen)
            train_resblock_rows(dev, gen, max(2, iters // 4), add)
        if "self_attention" in only:
            self_attention_rows(dev, gen, 5 * iters, add)
        if "flash_attention" in only:
            train_attention_rows(dev, gen, 5 * iters, add)
            f32_attention_rows(dev, gen, iters, add)
        return {k: a for k, a in agg.items() if a.get("seen")}

    resblock_rows(dev, gen, iters, add)
    self_attention_rows(dev, gen, 5 * iters, add)
    check_odd_shapes(dev, gen)
    check_k5_odd_shapes(dev, gen)
    train_resblock_rows(dev, gen, max(2, iters // 4), add)
    train_attention_rows(dev, gen, 5 * iters, add)
    f32_attention_rows(dev, gen, iters, add)
    adamw_row(dev, gen, iters, add)
    return agg


def resblock_rows(dev, gen, iters, add) -> None:
    """K1 at the 12 shapes and K2 at the 4 shapes of the IN64 sampling forward
    (model batch 128)."""
    from sgdm_tpu_torch.ops import resblock as rb

    for h, w, cin, cout, calls in K1_SHAPES:
        x, o = resblock_operands(gen, h, w, cin, cout, dev)
        args = [o[k] for k in ("gn1_scale", "gn1_bias", "w1", "b1", "film_scale",
                               "film_shift", "gn2_scale", "gn2_bias", "w2", "b2")]
        skw, skb = o.get("skip_w"), o.get("skip_b")
        err, scale, ms, pms, lms = check_kernel(
            lambda: rb.resblock_cuda(x, *args, skw, skb),
            lambda: rb.resblock_plain(x, *args, skw, skb),
            lambda: library_resblock(x, o), iters)
        bnd, by = roofline.resblock_cost(MODEL_BATCH, h, w, cin, cout, None,
                                         skw is not None).bound()
        row = dict(kernel="resblock", shape=[MODEL_BATCH, h, w, cin, cout], calls=calls,
                   max_abs_err=err, max_abs_ref=scale, ms=ms, plain_ms=pms,
                   library_ms=lms, bound_ms=bnd, bound_by=by)
        print(json.dumps(row), flush=True)
        assert err <= RESBLOCK_TOL * max(scale, 1.0), f"K1 {row['shape']}: err {err}"
        add("resblock", calls, err, ms, pms, lms, bnd, by)

    for h, c, resample in K2_SHAPES:
        x, o = resblock_operands(gen, h, h, c, c, dev)
        args = [o[k] for k in ("gn1_scale", "gn1_bias", "w1", "b1", "film_scale",
                               "film_shift", "gn2_scale", "gn2_bias", "w2", "b2")]
        err, scale, ms, pms, lms = check_kernel(
            lambda: rb.resblock_resample_cuda(x, *args, resample=resample),
            lambda: rb.resblock_plain(x, *args, resample=resample),
            lambda: library_resblock(x, o, resample), iters)
        bnd, by = roofline.resblock_cost(MODEL_BATCH, h, h, c, c, resample).bound()
        row = dict(kernel="resblock_resample", shape=[MODEL_BATCH, h, h, c, resample],
                   calls=1, max_abs_err=err, max_abs_ref=scale, ms=ms, plain_ms=pms,
                   library_ms=lms, bound_ms=bnd, bound_by=by)
        print(json.dumps(row), flush=True)
        assert err <= RESBLOCK_TOL * max(scale, 1.0), f"K2 {row['shape']}: err {err}"
        add("resblock_resample", 1, err, ms, pms, lms, bnd, by)
    print(json.dumps({"conv_kernel": dict(blocks_per_sm=rb.conv_blocks_per_sm(),
                                          ptxas=ptxas_usage("resblock", "conv_kernel"))}),
          flush=True)


def self_attention_rows(dev, gen, iters, add) -> None:
    """K3 at the IN64 sampling shape, on contiguous operands and on the
    strided views of a packed [B, N, 3, H, D] projection (what
    `SelfAttentionBlock` hands it), then correctness at odd shapes: ragged N
    (17, 100), N = 256 exactly at D = 32 and 128, and N = 1024 and 2048, which
    stream K/V in chunks with the online softmax.  Beyond one chunk of keys
    (N > 256; N > 128 at D = 128) the kernel rounds the unnormalised weights
    to bf16 and divides by the row sum last, where the plain version
    normalises first: a few bf16 ulps of the weights, inside ATTENTION_TOL."""
    import torch
    import torch.nn.functional as F

    from sgdm_tpu_torch.ops import attention as att

    b, nh, n, d = K3_SHAPE
    qkv = torch.randn(b, n, 3, nh, d, generator=gen, device=dev).to(torch.bfloat16)
    views = tuple(qkv.permute(2, 0, 3, 1, 4))     # [b, nh, n, d] each, no copy
    q, k, v = (t.contiguous() for t in views)
    err, scale, ms, pms, lms = check_kernel(
        lambda: att.self_attention_cuda(q, k, v),
        lambda: att.self_attention_plain(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0 / math.sqrt(d)), iters)
    out_s = att.self_attention_cuda(*views)
    torch.cuda.synchronize()
    with full_f32():
        ref = att.self_attention_plain(q, k, v)
    err_s = (out_s.float() - ref.float()).abs().max().item()
    same = bool((out_s == att.self_attention_cuda(q, k, v)).all())
    ms_s = cuda_time(lambda: att.self_attention_cuda(*views), iters)
    bnd, by = roofline.attention_cost(b, nh, n, d).bound()
    dev_t = device_ms_in_turns(
        lambda: att.self_attention_cuda(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0 / math.sqrt(d)), iters)
    row = dict(kernel="self_attention", shape=list(K3_SHAPE), calls=K3_CALLS, max_abs_err=err,
               max_abs_ref=scale, ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bnd,
               bound_by=by, **dev_t, strided_device_ms=device_ms(
                   lambda: att.self_attention_cuda(*views), iters),
               strided_max_abs_err=err_s, strided_ms=ms_s,
               strided_equals_contiguous=same,
               strided_out_is_bnhd=out_s.permute(0, 2, 1, 3).is_contiguous(),
               blocks_per_sm=att.forward_blocks_per_sm(n, d))
    print(json.dumps(row), flush=True)
    assert err <= ATTENTION_TOL * max(scale, 1.0), f"K3: err {err}"
    assert err_s <= ATTENTION_TOL * max(scale, 1.0) and same, f"K3 strided: err {err_s}"
    assert row["strided_out_is_bnhd"], "K3: output not allocated as [B, N, H, D]"
    add("self_attention", K3_CALLS, err, ms, pms, lms, bnd, by, dev_t)
    rows = []
    for b, nh, n, d in [(3, 2, 100, 32), (1, 3, 17, 128), (2, 1, 1024, 64), (2, 2, 256, 32),
                        (2, 2, 256, 128), (2, 1, 2048, 64)]:
        q, k, v = (torch.randn(b, nh, n, d, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        out = att.self_attention_cuda(q, k, v)
        with full_f32():
            ref = att.self_attention_plain(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        rows.append(dict(kernel="self_attention", shape=[b, nh, n, d],
                         max_abs_err=err, max_abs_ref=scale))
        assert torch.isfinite(out.float()).all() and err <= ATTENTION_TOL * max(scale, 1.0), \
            rows[-1]
    print(json.dumps({"odd_shapes": rows}), flush=True)


def train_resblock_rows(dev, gen, iters, add) -> None:
    """K4 and K5 at the 12 K1 shapes at model batch 128 (the same-resolution
    ResBlocks of one train step), dropout 0.1 with a fixed seed, identity and
    projection skips.  K5 runs on K4's residuals on both sides."""
    import torch

    from sgdm_tpu_torch.ops import resblock as rb

    names = ["dx", "dg1", "db1", "dw1", "dc1", "dfs", "dfsh", "dg2", "db2", "dw2", "dc2",
             "dskw", "dskb"]
    kw = dict(dropout_rate=DROPOUT, seed=DROPOUT_SEED)
    for h, w, cin, cout, calls in K1_SHAPES:
        x, o = resblock_operands(gen, h, w, cin, cout, dev, b=TRAIN_BATCH)
        args = [o[k] for k in ("gn1_scale", "gn1_bias", "w1", "b1", "film_scale",
                               "film_shift", "gn2_scale", "gn2_bias", "w2", "b2")]
        skw, skb = o.get("skip_w"), o.get("skip_b")
        k4 = lambda: rb.resblock_train_cuda(x, *args, skw, skb, **kw)
        p4 = lambda: rb.resblock_plain(x, *args, skw, skb, save_res=True, **kw)
        res = k4()
        with full_f32():
            ref = p4()
        torch.cuda.synchronize()
        err = (res[0].float() - ref[0].float()).abs().max().item()
        scale = ref[0].float().abs().max().item()
        res_err = max(rel_err(a, b) for a, b in zip(res[1:], ref[1:]))
        ms = cuda_time(k4, iters)
        with full_f32():
            pms = cuda_time(p4, max(1, iters // 2), warmup=1)
        lms = cuda_time(lambda: library_resblock(x, o), iters)
        bnd, by = roofline.resblock_cost(TRAIN_BATCH, h, w, cin, cout, None, skw is not None,
                                         residuals=True).bound()
        row = dict(kernel="resblock_train", shape=[TRAIN_BATCH, h, w, cin, cout], calls=calls,
                   max_abs_err=err, max_abs_ref=scale, residual_rel_err=res_err, ms=ms,
                   plain_ms=pms, library_ms=lms, bound_ms=bnd, bound_by=by)
        print(json.dumps(row), flush=True)
        assert err <= RESBLOCK_TOL * max(scale, 1.0), f"K4 {row['shape']}: err {err}"
        assert res_err <= RESBLOCK_TOL, f"K4 {row['shape']}: residual err {res_err}"
        add("resblock_train", calls, err, ms, pms, lms, bnd, by)

        dout = torch.randn(res[0].shape, generator=gen, device=dev).to(torch.bfloat16)
        bargs = (x, dout, *res[1:], args[0], args[1], args[2], args[4], args[5], args[6],
                 args[7], args[8], skw)
        k5 = lambda: rb.resblock_bwd_cuda(*bargs, **kw)
        p5 = lambda: rb.resblock_bwd_plain(*bargs, **kw)
        got = k5()
        with full_f32():
            want = p5()
        torch.cuda.synchronize()
        errs = {n: rel_err(a, b) for n, a, b in zip(names, got, want) if b is not None}
        assert all(torch.isfinite(g.float()).all() for g in got if g is not None)
        worst = max(errs, key=errs.get)
        ms = cuda_time(k5, iters)
        with full_f32():
            pms = cuda_time(p5, max(1, iters // 2), warmup=1)
        lms = cuda_time(lambda: library_resblock_grad(x, o, dout), iters)
        lib_bwd = library_resblock_bwd(x, o, dout)
        lbms = cuda_time(lib_bwd, iters)
        del lib_bwd
        bnd, by = roofline.resblock_bwd_cost(TRAIN_BATCH, h, w, cin, cout,
                                             skw is not None).bound()
        row = dict(kernel="resblock_bwd", shape=[TRAIN_BATCH, h, w, cin, cout], calls=calls,
                   max_rel_err=errs[worst], worst_grad=worst, rel_err=errs, ms=ms,
                   plain_ms=pms, library_ms=lms, library_bwd_ms=lbms, bound_ms=bnd,
                   bound_by=by)
        print(json.dumps(row), flush=True)
        assert errs[worst] <= K5_TOL, f"K5 {row['shape']}: {worst} rel err {errs[worst]}"
        add("resblock_bwd", calls, errs[worst], ms, pms, lms, bnd, by, lib_bwd_ms=lbms)
    print(json.dumps({"resblock_bwd_kernels": dict(
        rb.bwd_blocks_per_sm(), ptxas=dict(
            wgrad=ptxas_usage("resblock_bwd", "wgrad_kernel"),
            dgrad=ptxas_usage("resblock_bwd", "conv_kernel"),
            gn_bwd=ptxas_usage("resblock_bwd", "gn_bwd_kernel")))}), flush=True)


def train_attention_rows(dev, gen, iters, add) -> None:
    """K9 forward and backward at the training shape [128, 8, 256, 64] (the
    backward runs on the forward kernel's lse), then odd shapes."""
    import torch
    import torch.nn.functional as F

    from sgdm_tpu_torch.ops import attention as att

    b, nh, n, d = K9_SHAPE
    q, k, v, do = (torch.randn(b, nh, n, d, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    fwd = lambda: att.flash_attention_fwd_cuda(q, k, v)
    out, lse = fwd()
    with full_f32():
        ref, ref_lse = att.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    lse_err = rel_err(lse, ref_lse)
    ms = cuda_time(fwd, iters)
    with full_f32():
        pms = cuda_time(lambda: att.flash_attention_plain(q, k, v), max(1, iters // 2), 1)
    sdpa = lambda qq, kk, vv: F.scaled_dot_product_attention(qq, kk, vv, scale=1.0 / math.sqrt(d))
    lms = cuda_time(lambda: sdpa(q, k, v), iters)
    bnd, by = roofline.attention_cost(b, nh, n, d, lse=True).bound()
    dev_t = device_ms_in_turns(fwd, lambda: sdpa(q, k, v), iters)
    row = dict(kernel="flash_attention_fwd", shape=list(K9_SHAPE), calls=K9_CALLS,
               max_abs_err=err, max_abs_ref=scale, lse_rel_err=lse_err, ms=ms, plain_ms=pms,
               library_ms=lms, bound_ms=bnd, bound_by=by, **dev_t)
    print(json.dumps(row), flush=True)
    assert err <= ATTENTION_TOL * max(scale, 1.0) and lse_err <= 1e-5, row
    add("flash_attention_fwd", K9_CALLS, err, ms, pms, lms, bnd, by, dev_t)

    bwd = lambda: att.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    got = bwd()
    with full_f32():
        want = att.flash_attention_bwd_plain(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    errs = {name: rel_err(a, w) for name, a, w in zip(("dq", "dk", "dv"), got, want)}
    # the training block's route: q, k, v views of a packed [B, N, 3, H, D]
    # projection, o and dO [B, H, N, D] views of [B, N, H, D] tensors, and the
    # gradients written into one packed [B, N, 3, H, D] buffer
    packed = torch.stack((q, k, v), 2).permute(0, 3, 2, 1, 4).contiguous()
    qs, ks, vs = packed.permute(2, 0, 3, 1, 4)
    os_, dos = (t.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3) for t in (out, do))
    dpacked = torch.empty_like(packed)
    bwd_s = lambda: att.flash_attention_bwd_cuda(qs, ks, vs, os_, lse, dos,
                                                 grads=tuple(dpacked.permute(2, 0, 3, 1, 4)))
    got_s = bwd_s()
    torch.cuda.synchronize()
    strided_equal = all(bool((a == b).all()) for a, b in zip(got_s, got))
    strided_ms = cuda_time(bwd_s, iters)
    ms = cuda_time(bwd, iters)
    with full_f32():
        pms = cuda_time(lambda: att.flash_attention_bwd_plain(q, k, v, out, lse, do),
                        max(1, iters // 2), 1)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = sdpa(qs, ks, vs)
    lms = cuda_time(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do, retain_graph=True),
                    iters)
    bnd, by = roofline.attention_bwd_cost(b, nh, n, d).bound()
    worst = max(errs.values())
    row = dict(kernel="flash_attention_bwd", shape=list(K9_SHAPE), calls=K9_CALLS,
               max_rel_err=worst, rel_err=errs, ms=ms, plain_ms=pms, library_ms=lms,
               bound_ms=bnd, bound_by=by,
               strided_ms=strided_ms, strided_equals_contiguous=strided_equal,
               blocks_per_sm=att.backward_blocks_per_sm(d),
               ptxas=ptxas_usage("attention", "attn_bwd_kernel"))
    print(json.dumps(row), flush=True)
    assert worst <= K9_TOL and strided_equal, row
    add("flash_attention_bwd", K9_CALLS, worst, ms, pms, lms, bnd, by)
    rows = []
    for b, nh, n, d in [(3, 2, 100, 64), (1, 3, 17, 128), (2, 1, 1024, 64), (2, 2, 256, 128)]:
        q, k, v, do = (torch.randn(b, nh, n, d, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        out, lse = att.flash_attention_fwd_cuda(q, k, v)
        got = att.flash_attention_bwd_cuda(q, k, v, out, lse, do)
        with full_f32():
            ref, ref_lse = att.flash_attention_plain(q, k, v)
            want = att.flash_attention_bwd_plain(q, k, v, out, lse, do)
        err = max([rel_err(out, ref)] + [rel_err(a, w) for a, w in zip(got, want)])
        rows.append(dict(kernel="flash_attention", shape=[b, nh, n, d], max_rel_err=err,
                         lse_rel_err=rel_err(lse, ref_lse)))
        assert err <= K9_TOL and rows[-1]["lse_rel_err"] <= 1e-5, rows[-1]
    # the autograd entry on layouts the kernels do not read in place: a
    # transposed q and the stride-0 dO of `out.sum().backward()`, copied first
    b, nh, n, d = 2, 2, 256, 64
    q = torch.randn(b, nh, d, n, generator=gen, device=dev).to(torch.bfloat16).transpose(-1, -2)
    k, v = (torch.randn(b, nh, n, d, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    grads = []
    for kernels in (True, False):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with full_f32():
            att.flash_attention(*leaves, kernels=kernels).sum().backward()
        grads.append([t.grad for t in leaves])
    err = max(rel_err(a, w) for a, w in zip(*grads))
    rows.append(dict(kernel="flash_attention", shape=[b, nh, n, d],
                     layout="transposed q, expanded dO", max_rel_err=err))
    assert err <= K9_TOL, rows[-1]
    print(json.dumps({"odd_shapes": rows}), flush=True)


def f32_attention_rows(dev, gen, iters, add) -> None:
    """K9 on f32 operands at the classifier's shape [128, 8, 256, 64], the
    operands strided views of a packed [B, N, 3, H, D] projection as the
    encoder's block hands them over, forward and backward against the plain
    versions (f32 matmuls, TF32 off); two backward runs bit for bit; device
    time of each kernel and of SDPA's f32 kernels in turns; each kernel's
    ptxas report (no spills) and blocks an SM; then odd shapes."""
    import torch
    import torch.nn.functional as F

    from sgdm_tpu_torch.ops import attention as att

    b, nh, n, d = K9_F32_SHAPE
    packed = torch.randn(b, n, 3, nh, d, generator=gen, device=dev)
    q, k, v = packed.permute(2, 0, 3, 1, 4)
    do = torch.randn(b, nh, n, d, generator=gen, device=dev)
    occupancy = att.f32_blocks_per_sm(d)
    fwd = lambda: att.flash_attention_fwd_f32_cuda(q, k, v)
    out, lse = fwd()
    with full_f32():
        ref, ref_lse = att.flash_attention_plain(q, k, v)
        plain_fwd = lambda: att.flash_attention_plain(q, k, v)
        pms = cuda_time(plain_fwd, max(1, iters // 2), 1)
    torch.cuda.synchronize()
    err, lse_err = rel_err(out, ref), rel_err(lse, ref_lse)
    ms = cuda_time(fwd, iters)
    sdpa = lambda qq, kk, vv: F.scaled_dot_product_attention(qq, kk, vv, scale=1.0 / math.sqrt(d))
    with full_f32():
        lms = cuda_time(lambda: sdpa(q, k, v), iters)
        dev_t = device_ms_in_turns(fwd, lambda: sdpa(q, k, v), iters)
    bnd, by = roofline.attention_cost(b, nh, n, d, itemsize=4, lse=True).bound()
    ptxas = ptxas_usage("attention", "f32_fwd_kernel")
    row = dict(kernel="flash_attention_fwd_f32", shape=list(K9_F32_SHAPE), calls=CLS_K9,
               max_rel_err=err, lse_rel_err=lse_err, ms=ms, plain_ms=pms, library_ms=lms,
               bound_ms=bnd, bound_by=by, **dev_t, bound_share=bnd / dev_t["device_ms"],
               blocks_per_sm=occupancy["fwd"], ptxas=ptxas)
    print(json.dumps(row), flush=True)
    assert err <= K9_F32_TOL and lse_err <= K9_F32_TOL, row
    assert ptxas and all(r.get("spill_stores", 1) == 0 for r in ptxas.values()), row
    add("flash_attention_fwd_f32", CLS_K9, err, ms, pms, lms, bnd, by, dev_t)

    bwd = lambda: att.flash_attention_bwd_f32_cuda(q, k, v, out, lse, do)
    got = bwd()
    again = bwd()
    with full_f32():
        want = att.flash_attention_bwd_plain(q, k, v, out, lse, do)
        pms = cuda_time(lambda: att.flash_attention_bwd_plain(q, k, v, out, lse, do),
                        max(1, iters // 2), 1)
    torch.cuda.synchronize()
    errs = {name: rel_err(a, w) for name, a, w in zip(("dq", "dk", "dv"), got, want)}
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    ms = cuda_time(bwd, iters)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with full_f32():
        lib_out = sdpa(*leaves)
        lib_bwd = lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True)
        lms = cuda_time(lib_bwd, iters)
        dev_t = device_ms_in_turns(bwd, lib_bwd, iters)
    bnd, by = roofline.attention_bwd_cost(b, nh, n, d, itemsize=4).bound()
    worst = max(errs.values())
    ptxas = ptxas_usage("attention", "f32_bwd_kernel")
    row = dict(kernel="flash_attention_bwd_f32", shape=list(K9_F32_SHAPE), calls=CLS_K9,
               max_rel_err=worst, rel_err=errs, bit_identical=same, ms=ms, plain_ms=pms,
               library_ms=lms, bound_ms=bnd, bound_by=by, **dev_t,
               bound_share=bnd / dev_t["device_ms"], blocks_per_sm=occupancy["bwd"],
               ptxas=ptxas)
    print(json.dumps(row), flush=True)
    assert worst <= K9_F32_TOL, row
    assert same, "K9 f32 backward: two runs on the same inputs differ"
    assert ptxas and all(r.get("spill_stores", 1) == 0 for r in ptxas.values()), row
    add("flash_attention_bwd_f32", CLS_K9, worst, ms, pms, lms, bnd, by, dev_t)
    rows = []
    for b, nh, n, d in [(3, 2, 100, 64), (1, 3, 17, 128), (2, 2, 300, 128), (2, 1, 1024, 64)]:
        q, k, v, do = (torch.randn(b, nh, n, d, generator=gen, device=dev) for _ in range(4))
        out, lse = att.flash_attention_fwd_f32_cuda(q, k, v)
        got = att.flash_attention_bwd_f32_cuda(q, k, v, out, lse, do)
        same = all(torch.equal(a, c) for a, c in
                   zip(got, att.flash_attention_bwd_f32_cuda(q, k, v, out, lse, do)))
        # K3's f32 forward is the same kernel without the lse
        k3 = att.self_attention_cuda(q, k, v)
        with full_f32():
            ref, ref_lse = att.flash_attention_plain(q, k, v)
            want = att.flash_attention_bwd_plain(q, k, v, out, lse, do)
        err = max([rel_err(out, ref), rel_err(k3, ref), rel_err(lse, ref_lse)]
                  + [rel_err(a, w) for a, w in zip(got, want)])
        rows.append(dict(kernel="flash_attention_f32", shape=[b, nh, n, d], max_rel_err=err,
                         bit_identical=same))
        assert err <= K9_F32_TOL and same, rows[-1]
    print(json.dumps({"odd_shapes_f32": rows}), flush=True)


def adamw_row(dev, gen, iters, add) -> None:
    """K8 over the full IN64 tree (74,252,803 f32 parameters, one flat buffer)."""
    import torch

    from sgdm_tpu_torch.models.factory import UNET_FAST_IN64, create_denoiser
    from sgdm_tpu_torch.ops import fused_optim as fo
    from sgdm_tpu_torch.training.optim import lambda_linear_schedule

    n = N_PARAMS_IN64
    r = lambda: torch.randn(n, generator=gen, device=dev)
    bufs = [r(), r(), 1e-3 * r(), 1e-6 * r().abs(), r()]   # p, g, mu, nu, ema
    ref = [t.clone() for t in bufs]
    sc = fo.adamw_ema_scalars(lambda_linear_schedule(1e-4), 500, 500, weight_decay=0.01)
    fo.adamw_ema_cuda(*bufs, **sc)
    fo.adamw_ema_plain(*ref, **sc)
    torch.cuda.synchronize()
    err = max(rel_err(a, b) for a, b in zip(bufs, ref))
    ms = cuda_time(lambda: fo.adamw_ema_cuda(*bufs, **sc), iters)
    pms = cuda_time(lambda: fo.adamw_ema_plain(*ref, **sc), max(1, iters // 2), 1)
    del ref
    shapes = [tuple(p.shape) for p in create_denoiser(
        **dict(UNET_FAST_IN64, cond_dim=1000)).parameters()]
    assert sum(math.prod(s) for s in shapes) == n
    leaves = [torch.randn(s, generator=gen, device=dev).requires_grad_() for s in shapes]
    for t in leaves:
        t.grad = torch.randn(t.shape, generator=gen, device=dev)
    ema = [t.detach().clone() for t in leaves]
    opt = torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
                            fused=True)
    detached = [t.detach() for t in leaves]

    def library():
        opt.step()
        torch._foreach_lerp_(ema, detached, 1.0 - 0.9999)

    lms = cuda_time(library, iters)
    del leaves, ema, opt, detached
    bnd, by = roofline.adamw_ema_cost(n).bound()
    row = dict(kernel="adamw_ema", shape=[n], calls=1, leaves=len(shapes), max_rel_err=err,
               ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bnd, bound_by=by)
    print(json.dumps(row), flush=True)
    assert err <= K8_TOL, row
    add("adamw_ema", 1, err, ms, pms, lms, bnd, by)


def check_odd_shapes(dev, gen) -> None:
    """Correctness only, at shapes the IN64 paths never give: channel counts
    that are not multiples of 8 (the kernels' scalar load paths), widths
    that do not fill a tile; for K1 and K2, then K4/K5 (dropout on).  (The
    attention kernels' odd shapes are with their rows.)"""
    import torch

    from sgdm_tpu_torch.ops import resblock as rb

    rows = []
    # the convolution's 16 x 16 tiles overhang every one of these images; Ci
    # that fill no whole 32-channel chunk, Co no whole 128-channel tile
    for h, w, cin, cout, resample in [(8, 24, 36, 20, None), (10, 6, 40, 40, None),
                                      (12, 10, 24, 24, "down"), (5, 7, 20, 20, "up"),
                                      (6, 8, 40, 48, None), (20, 20, 160, 200, None),
                                      (34, 18, 136, 136, "down"), (9, 17, 104, 104, "up"),
                                      (17, 19, 44, 52, None)]:
        x, o = resblock_operands(gen, h, w, cin, cout, dev, b=3)
        args = [o[k] for k in ("gn1_scale", "gn1_bias", "w1", "b1", "film_scale",
                               "film_shift", "gn2_scale", "gn2_bias", "w2", "b2")]
        skw, skb = o.get("skip_w"), o.get("skip_b")
        if resample is None:
            out = rb.resblock_cuda(x, *args, skw, skb)
        else:
            out = rb.resblock_resample_cuda(x, *args, resample=resample)
        with full_f32():
            ref = rb.resblock_plain(x, *args, skw, skb, resample=resample)
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        rows.append(dict(kernel="resblock", shape=[3, h, w, cin, cout, resample],
                         max_abs_err=err, max_abs_ref=scale))
        assert err <= RESBLOCK_TOL * max(scale, 1.0), rows[-1]
    kw = dict(dropout_rate=DROPOUT, seed=DROPOUT_SEED)
    for h, w, cin, cout in [(8, 24, 36, 20), (10, 6, 40, 40), (6, 8, 40, 48), (5, 7, 20, 20),
                            (20, 20, 160, 200), (17, 19, 44, 52)]:
        x, o = resblock_operands(gen, h, w, cin, cout, dev, b=3)
        args = [o[k] for k in ("gn1_scale", "gn1_bias", "w1", "b1", "film_scale",
                               "film_shift", "gn2_scale", "gn2_bias", "w2", "b2")]
        skw, skb = o.get("skip_w"), o.get("skip_b")
        res = rb.resblock_train_cuda(x, *args, skw, skb, **kw)
        with full_f32():
            ref = rb.resblock_plain(x, *args, skw, skb, save_res=True, **kw)
        dout = torch.randn(res[0].shape, generator=gen, device=dev).to(torch.bfloat16)
        bargs = (x, dout, *res[1:], args[0], args[1], args[2], args[4], args[5], args[6],
                 args[7], args[8], skw)
        got = rb.resblock_bwd_cuda(*bargs, **kw)
        with full_f32():
            want = rb.resblock_bwd_plain(*bargs, **kw)
        err4 = max(rel_err(a, b) for a, b in zip(res, ref))
        err5 = max(rel_err(a, b) for a, b in zip(got, want) if b is not None)
        rows.append(dict(kernel="resblock_train+bwd", shape=[3, h, w, cin, cout],
                         k4_rel_err=err4, k5_rel_err=err5))
        assert err4 <= RESBLOCK_TOL and err5 <= K5_TOL, rows[-1]
    print(json.dumps({"odd_shapes": rows}), flush=True)


def check_k5_odd_shapes(dev, gen) -> None:
    """K5 alone at shapes the IN64 paths never give, on K4's residuals with
    dropout: ragged H and W (tiles of 16 x 16 that overhang, an image inside
    one tile), channel counts that fill no 64-wide weight-gradient block and
    are not multiples of 8 (the padded-copy path), B = 3, projection and
    identity skips."""
    import torch

    from sgdm_tpu_torch.ops import resblock as rb

    kw = dict(dropout_rate=DROPOUT, seed=DROPOUT_SEED)
    rows = []
    for h, w, cin, cout in [(13, 21, 44, 52), (5, 7, 20, 24), (20, 18, 136, 64),
                            (33, 17, 72, 72), (16, 16, 100, 100), (31, 9, 200, 136),
                            (3, 40, 12, 12)]:
        x, o = resblock_operands(gen, h, w, cin, cout, dev, b=3)
        args = [o[k] for k in ("gn1_scale", "gn1_bias", "w1", "b1", "film_scale",
                               "film_shift", "gn2_scale", "gn2_bias", "w2", "b2")]
        skw = o.get("skip_w")
        res = rb.resblock_train_cuda(x, *args, skw, o.get("skip_b"), **kw)
        dout = torch.randn(res[0].shape, generator=gen, device=dev).to(torch.bfloat16)
        bargs = (x, dout, *res[1:], args[0], args[1], args[2], args[4], args[5], args[6],
                 args[7], args[8], skw)
        got = rb.resblock_bwd_cuda(*bargs, **kw)
        with full_f32():
            want = rb.resblock_bwd_plain(*bargs, **kw)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got if g is not None)
        err = max(rel_err(a, b) for a, b in zip(got, want) if b is not None)
        rows.append(dict(kernel="resblock_bwd", shape=[3, h, w, cin, cout], k5_rel_err=err,
                         finite=finite))
        assert finite and err <= K5_TOL, rows[-1]
    print(json.dumps({"odd_shapes": rows}), flush=True)


# ---------------------------------------------------------------- phases 3, 4

def build_model(dev, seed: int = 0):
    import torch

    from sgdm_tpu_torch.models.factory import UNET_FAST_IN64, create_denoiser, \
        init_random_params

    cfg = dict(UNET_FAST_IN64, cond_dim=1000)
    model = create_denoiser(dtype=torch.bfloat16, **cfg)
    init_random_params(model, seed)
    return cfg, model.to(dev).eval()


def forward_on_off(tag: str, model, x, t, mask, want: dict | None = None, **cond) -> None:
    """One forward with kernels on and one with their plain versions: relative
    max error under FORWARD_TOL; with ``want``, the exact launch counts of the
    kernels-on forward."""
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.models.layers import set_kernels

    with torch.inference_mode(), full_f32():  # only the kernels differ
        set_kernels(model, True)
        ops.reset_launch_counts()
        eps_k = model(x, t, cond_drop_mask=mask, **cond)
        counts = ops.launch_counts()
        set_kernels(model, False)
        eps_p = model(x, t, cond_drop_mask=mask, **cond)
        set_kernels(model, True)
    torch.cuda.synchronize()
    assert eps_k.shape == x.shape and torch.isfinite(eps_k).all()
    rel = ((eps_k - eps_p).abs().max() / eps_p.abs().max()).item()
    row = dict(rel_max_err=rel, max_abs_eps=eps_p.abs().max().item())
    if want is not None:
        row["launches"] = {k: v for k, v in counts.items() if v}
    print(json.dumps({tag: row}), flush=True)
    assert rel <= FORWARD_TOL, f"{tag}: kernels-on vs kernels-off forward: rel err {rel}"
    if want is not None:
        assert counts == dict({k: 0 for k in META}, **want), f"{tag}: launch counts {counts}"


def forward_inputs(dev, size: int = 64, seed: int = 1):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    b = MODEL_BATCH
    x = torch.randn(b, size, size, 3, generator=gen, device=dev)
    t = torch.randint(1, 1000, (b,), generator=gen, device=dev)
    mask = torch.arange(b, device=dev) >= b // 2
    return gen, x, t, mask


def one_hot_ids(gen, dev, b: int, classes: int = 1000):
    import torch

    return torch.nn.functional.one_hot(
        torch.randint(0, classes, (b,), generator=gen, device=dev), classes).float()


def phase_forward(dev, model) -> None:
    gen, x, t, mask = forward_inputs(dev)
    forward_on_off("forward", model, x, t, mask, cond=one_hot_ids(gen, dev, MODEL_BATCH))


def phase_sample(dev, cfg, model, card: str, per_step: dict | None = None, tag: str = "sample",
                 steps: int | None = 50, sampler: str = "ddim", diffusion=None,
                 small_diffusion=None, **cond) -> dict:
    """The serving path through `generate` with ``sampler``: a 4-image
    4-step sample kernels on vs off under full f32 (on ``small_diffusion``,
    default ``diffusion``), then, after a warm-up of 4 steps at the served
    shape, 64 images in ``steps`` steps (None: the sampler's default) on
    ``diffusion`` (None: the 1000-step linear one), with the launch counters
    set to 0 just before and read just after; ``per_step`` is the expected
    count of each kernel per model forward (None: IN64's K1 17, K2 4, K3 6;
    the others 0), the forwards counted from the sampler's own steps."""
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.diffusion.core import GaussianDiffusion
    from sgdm_tpu_torch.generate import generate
    from sgdm_tpu_torch.models.layers import set_kernels

    diffusion = diffusion or GaussianDiffusion()
    few = dict(steps=4, diffusion=small_diffusion or diffusion)
    n = SAMPLE_N
    kw = dict(n=n, batch_size=n, cond_scale=2.0, seed=0, device=dev, model=model,
              sampler=sampler, **cond)
    # small input, kernels on vs off (plain versions), same seed and x_T draw;
    # where the path runs K1, once more with K1 faulty
    small = dict(kw, n=4, batch_size=4, **few)
    runs_k1 = per_step is None or "resblock" in per_step
    with torch.inference_mode():
        with full_f32():  # only the kernels differ
            img_k = generate(cfg, **small)
            set_kernels(model, False)
            img_p = generate(cfg, **small)
            set_kernels(model, True)
            if runs_k1:
                with k1_fault(RESBLOCK_TOL):
                    img_f = generate(cfg, **small)
        diff = (img_k.int() - img_p.int()).abs()
        small_row = dict(max_uint8_diff=int(diff.max()),
                         mean_uint8_diff=float(diff.float().mean()), limit=SAMPLE_TOL[sampler])
        if runs_k1:
            small_row["k1_fault_mean_uint8_diff"] = float(
                (img_f.int() - img_p.int()).abs().float().mean())
        print(json.dumps({f"{tag}_small": small_row}), flush=True)
        assert small_row["mean_uint8_diff"] <= SAMPLE_TOL[sampler], (tag, small_row)
        assert small_row.get("k1_fault_mean_uint8_diff", math.inf) > SAMPLE_TOL[sampler], \
            (tag, "a faulty K1 passes the check", small_row)

        generate(cfg, **dict(kw, **few))  # warm-up at the served shape
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        imgs = generate(cfg, **dict(kw, steps=steps, diffusion=diffusion))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = ops.launch_counts()
    assert imgs.dtype == torch.uint8 and tuple(imgs.shape) == (n, 64, 64, 3), imgs.shape
    assert imgs.float().std().item() > 0, f"{tag}: constant images"
    pngs = png_round_trip(imgs[:4].cpu().numpy(), tag)
    forwards = sampler_forwards(sampler, diffusion, steps)
    want = (sampling_launches(forwards) if per_step is None else
            dict({k: 0 for k in META}, **{k: forwards * v for k, v in per_step.items()}))
    print(json.dumps({tag: dict(card=card, n=n, sampler=sampler, forwards=forwards,
                                seconds=elapsed, pngs=pngs, forwards_per_s=forwards / elapsed,
                                ms_per_forward=1e3 * elapsed / forwards,
                                images_per_s=n / elapsed, launches=counts,
                                mean_pixel=float(imgs.float().mean()))}), flush=True)
    assert counts == want, f"{tag}: launch counts {counts} != {want}"
    return counts


def sampler_forwards(name: str, diffusion, steps: int | None) -> int:
    """UNet forwards of one ``name`` sampler call (``steps`` None: its
    default), counted from the sampler's own timestep lists."""
    from sgdm_tpu_torch.diffusion.samplers import continuous, ddim, edm, pndm
    from sgdm_tpu_torch.diffusion.schedule import make_ddim_timesteps

    steps = steps or (250 if name == "vdm" else 50)
    if name == "native":
        return diffusion.num_timesteps
    if name in ("ddim", "plms"):   # plms: the first step calls the model twice
        return (len(ddim.make_ddim_schedule(diffusion.schedule, steps).timesteps)
                + (name == "plms"))
    if name == "pndm":
        warmup, main = pndm.pndm_time_steps(diffusion.num_timesteps, steps)
        return len(warmup) + len(main)
    if name == "tero":   # Heun on every step
        return 2 * len(edm.edm_schedule(steps)[1])
    if name == "vdm":
        return len(continuous.vdm_log_snr_table(continuous.alpha_cosine_log_snr, steps)) - 1
    if name == "ddim_continuous":
        return len(make_ddim_timesteps("uniform", steps, diffusion.num_timesteps))
    raise KeyError(name)


def phase_samplers(dev, cfg, model, card: str) -> dict:
    """Every sampler of the registry but DDIM (phase sample's) through
    `phase_sample`, each at its default steps but vdm (VDM_STEPS); vdm and
    ddim_continuous on the cosine schedule, the others on the linear one;
    native, which walks every timestep, on a linear schedule of NATIVE_T;
    its kernels on/off check on a diffusion of 8 timesteps."""
    from sgdm_tpu_torch.diffusion.core import GaussianDiffusion

    linear, cosine = GaussianDiffusion(), GaussianDiffusion(beta_schedule="cosine")
    diffusion = dict(native=GaussianDiffusion(num_timesteps=NATIVE_T), vdm=cosine,
                     ddim_continuous=cosine)
    return {f"samplers_{name}": phase_sample(
        dev, cfg, model, card, tag=f"samplers_{name}",
        steps=VDM_STEPS if name == "vdm" else None, sampler=name,
        diffusion=diffusion.get(name, linear),
        small_diffusion=GaussianDiffusion(num_timesteps=8) if name == "native" else None)
        for name in SAMPLERS}


def phase_mask_dir(dev, cfg, model, card: str) -> dict:
    """``--mask-dir`` on VOC64: MASK_DIR_FILES grey id masks written by
    `write_png` at MASK_DIR_PX px into build/, `generate(mask_dir=…)` of 64
    images in MASK_DIR_STEPS DDIM steps with exact counts, held bit for bit
    against `generate(layout=…, cond=…)` on `masks_to_layouts`' arrays."""
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.generate import generate, masks_to_layouts, write_png

    rng = np.random.default_rng(4)
    out = Path(__file__).resolve().parent / "build" / "mask_dir"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    try:
        for i in range(MASK_DIR_FILES):   # segments of 12 px, some pixels ignored (255)
            m = rng.integers(0, 21, (MASK_DIR_PX // 12, MASK_DIR_PX // 12)).astype(np.uint8)
            m = m.repeat(12, 0).repeat(12, 1)
            m[rng.random(m.shape) < 0.05] = 255
            write_png(out / f"{i:03d}.png", m)
        kw = dict(n=SAMPLE_N, batch_size=SAMPLE_N, steps=MASK_DIR_STEPS, cond_scale=2.0, seed=0,
                  device=dev, model=model)
        with torch.inference_mode():
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            imgs = generate(cfg, mask_dir=out, **kw)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            counts = ops.launch_counts()
            layouts, attrs = masks_to_layouts(out, SAMPLE_N, 64, 21, 21)
            same = torch.equal(generate(cfg, layout=layouts, cond=attrs, **kw), imgs)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    want = dict({k: 0 for k in META},
                **{k: MASK_DIR_STEPS * v for k, v in CA_SAMPLE_LAUNCHES.items()})
    print(json.dumps({"samplers_mask_dir": dict(
        card=card, n=SAMPLE_N, steps=MASK_DIR_STEPS, masks=MASK_DIR_FILES, seconds=elapsed,
        bit_identical_to_layouts=same, launches=counts,
        classes_per_image=float(attrs.sum(1).mean()))}), flush=True)
    assert same, "generate(mask_dir=) differs from generate(layout=) on the same arrays"
    assert imgs.float().std().item() > 0, "constant images"
    assert counts == want, f"mask_dir: launch counts {counts} != {want}"
    return counts


def png_round_trip(imgs, tag: str) -> dict:
    """Writes ``imgs`` (uint8 [n, H, W, 3]) as the serving entry point writes
    them (`generate._write_pngs`, the standard library's zlib alone) into
    build/ of this checkout, reads them back with `generate.read_png` and
    holds them equal; the directory is removed after."""
    import shutil
    from pathlib import Path

    import numpy as np

    from sgdm_tpu_torch.generate import _write_pngs, read_png

    out = Path(__file__).resolve().parent / "build" / f"pngs_{tag}"
    shutil.rmtree(out, ignore_errors=True)
    try:
        paths = _write_pngs(imgs, [], out)
        same = all(np.array_equal(read_png(p), img) for p, img in zip(paths, imgs))
        row = dict(written=len(paths), names=[p.name for p in paths], read_back_equal=same,
                   bytes=sum(p.stat().st_size for p in paths))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    assert row["written"] == len(imgs) and row["read_back_equal"], row
    return row


def build_model_ca(dev, seed: int = 0):
    import torch

    from sgdm_tpu_torch.models.factory import UNETCA_FAST_VOC64, create_denoiser, \
        init_random_params

    cfg = dict(UNETCA_FAST_VOC64)
    model = create_denoiser(dtype=torch.bfloat16, **cfg)
    init_random_params(model, seed)
    return cfg, model.to(dev).eval()


def layout_ids(gen, dev, n: int, classes: int = 21, size: int = 64, cell: int = 8):
    """Seeded layouts as uint8 id masks [n, size, size]: class ids drawn per
    ``cell``-pixel square (segments, not per-pixel noise)."""
    import torch

    coarse = torch.randint(0, classes, (n, size // cell, size // cell), generator=gen,
                           device=dev)
    return coarse.repeat_interleave(cell, 1).repeat_interleave(cell, 2).to(torch.uint8)


def phase_forward_ca(dev, model) -> None:
    import torch

    gen, x, t, mask = forward_inputs(dev)
    layout = torch.nn.functional.one_hot(layout_ids(gen, dev, MODEL_BATCH).long(), 21).float()
    cond = (layout.amax(dim=(1, 2)) > 0).float()
    forward_on_off("forward_ca", model, x, t, mask, CA_SAMPLE_LAUNCHES, cond=cond, layout=layout)


def phase_sample_ca(dev, cfg, model, card: str) -> dict:
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    return phase_sample(dev, cfg, model, card, CA_SAMPLE_LAUNCHES, "sample_ca",
                        layout=layout_ids(gen, dev, SAMPLE_N))


def build_model_b(dev, **overrides):
    """IN64 unet_fast with use_scale_shift_norm=False (every ResBlock unfused),
    or with ``overrides``, random weights."""
    import torch

    from sgdm_tpu_torch.models.factory import UNET_FAST_IN64, create_denoiser, \
        init_random_params

    cfg = dict(UNET_FAST_IN64, cond_dim=1000, **(overrides or dict(use_scale_shift_norm=False)))
    model = init_random_params(create_denoiser(dtype=torch.bfloat16, **cfg), 0)
    return cfg, model.to(dev).eval()


def phase_forward_b(dev, card: str) -> dict:
    """Path B: the unfused ResBlock route (K6) through two models."""
    cfg, model = build_model_b(dev)
    gen, x, t, mask = forward_inputs(dev)
    forward_on_off("forward_b", model, x, t, mask, B_LAUNCHES,
                   cond=one_hot_ids(gen, dev, MODEL_BATCH))
    counts = phase_sample(dev, cfg, model, card, B_LAUNCHES, "sample_b", steps=B_SAMPLE_STEPS)
    del model
    # the gate failing by width: FiLM stays, the 4-wide blocks run K6 with it
    cfg, model = build_model_b(dev, channel_mult=[1, 2, 4, 4], image_size=32)
    gen, x, t, mask = forward_inputs(dev, size=32)
    forward_on_off("forward_b_width", model, x, t, mask, B_WIDTH_LAUNCHES,
                   cond=one_hot_ids(gen, dev, MODEL_BATCH))
    return counts


def phase_profile(dev, cfg, model, steps: int = 4, tag: str = "profile", named=(),
                  **cond) -> None:
    """torch.profiler over a short guided sample at the served shape: device
    busy share of the wall time and device time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sgdm_tpu_torch.generate import generate

    kw = dict(n=SAMPLE_N, batch_size=SAMPLE_N, cond_scale=2.0, seed=0, device=dev, model=model,
              steps=steps, **cond)
    with torch.inference_mode():
        generate(cfg, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            generate(cfg, **kw)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (a CPU op's device time repeats its kernels')
    print(json.dumps({tag: dict(steps=steps, **profile_rows(prof, wall_us, named))}),
          flush=True)


def phase_profile_attention_block(dev, calls: int = 6) -> None:
    """torch.profiler over the sampling route of one `SelfAttentionBlock` of the
    IN64 model ([128, 16, 16, 512], 8 heads), as the block runs it now (q, k, v
    are views of the qkv projection, the kernel writes [B, N, H, D]) and as it
    ran before the kernel took strides (three contiguous copies in, one copy
    behind the output's permute): every device kernel by name, so the copy
    kernels around the attention show in the second list and not in the first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sgdm_tpu_torch.models.factory import init_random_params
    from sgdm_tpu_torch.models.layers import SelfAttentionBlock
    from sgdm_tpu_torch.ops import attention as att

    b, nh, n, d = K3_SHAPE
    side, c = math.isqrt(n), nh * d
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    # random weights: proj_out is not zero, so the attention output reaches the result
    block = init_random_params(SelfAttentionBlock(c, num_heads=nh, dtype=torch.bfloat16), 3)
    block = block.to(dev).eval()
    x = torch.randn(b, side, side, c, generator=gen, device=dev).to(torch.bfloat16)

    def with_copies():
        h = block.norm(x).reshape(b, n, c)
        qkv = block.qkv(h).reshape(b, n, 3, nh, d).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv)
        out = att.self_attention_cuda(q, k, v).contiguous()     # [B, H, N, D] in memory
        out = block.proj_out(out.permute(0, 2, 1, 3).reshape(b, n, c))
        return x + out.reshape(b, side, side, c)

    report = {}
    with torch.inference_mode():
        same = bool((block(x) == with_copies()).all())
        for tag, fn in (("now", lambda: block(x)), ("with_copies", with_copies)):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and e.self_device_time_total > 0), key=lambda r: -r[1])
            report[tag] = dict(
                device_ms_per_call=sum(r[1] for r in rows) / 1e3 / calls,
                copy_kernels_per_call=sum(r[2] for r in rows if "copy" in r[0].lower()) / calls,
                kernels=[dict(name=k[:90], device_ms_per_call=t / 1e3 / calls, per_call=cnt / calls)
                         for k, t, cnt in rows])
    print(json.dumps({"profile_attention_block": dict(shape=[b, side, side, c], calls=calls,
                                                      outputs_equal=same, **report)}), flush=True)
    assert same, "the strided route and the route with copies disagree"
    assert report["now"]["copy_kernels_per_call"] < report["with_copies"]["copy_kernels_per_call"]


def phase_profile_attention_block_train(dev, calls: int = 6) -> None:
    """torch.profiler over the training route of one `SelfAttentionBlock` of the
    IN64 model ([128, 16, 16, 512], 8 heads; K9 forward and backward), as it
    runs now (q, k, v are views of the qkv projection, the output is written as
    [B, N, H, D], dq, dk and dv go straight into the projection's gradient),
    with the same views through `flash_attention` (autograd stacks dq, dk and
    dv into the projection's gradient: that copy alone), and with the copies
    the route made before K9 took strides (q, k, v and the
    output made contiguous, dO made contiguous, dq, dk, dv stacked and copied
    back to the projection's layout): every device kernel by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sgdm_tpu_torch.models.factory import init_random_params
    from sgdm_tpu_torch.models.layers import SelfAttentionBlock
    from sgdm_tpu_torch.ops import attention as att

    class ContiguousGrad(torch.autograd.Function):  # dO as the earlier route copied it
        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            return g.contiguous()

    b, nh, n, d = K9_SHAPE
    side, c = math.isqrt(n), nh * d
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    block = init_random_params(SelfAttentionBlock(c, num_heads=nh, dtype=torch.bfloat16), 4)
    block = block.to(dev).train()
    x = torch.randn(b, side, side, c, generator=gen, device=dev).to(torch.bfloat16)
    x.requires_grad_()
    gout = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)
    leaves = [x] + list(block.parameters())

    def with_copies():
        h = block.norm(x).reshape(b, n, c)
        qkv = block.qkv(h).reshape(b, n, 3, nh, d).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv)
        out = ContiguousGrad.apply(att.flash_attention(q, k, v).contiguous())
        out = block.proj_out(out.permute(0, 2, 1, 3).reshape(b, n, c))
        return x + out.reshape(b, side, side, c)

    def unpacked():  # views in, but dq, dk, dv returned apart: autograd stacks them
        h = block.norm(x).reshape(b, n, c)
        q, k, v = block.qkv(h).reshape(b, n, 3, nh, d).permute(2, 0, 3, 1, 4)
        out = att.flash_attention(q, k, v)
        out = block.proj_out(out.permute(0, 2, 1, 3).reshape(b, n, c))
        return x + out.reshape(b, side, side, c)

    def step(fn):
        return torch.autograd.grad(fn(), leaves, gout)

    report = {}
    grads_now = step(lambda: block(x, train=True))
    # the same function: only the layout of the operands differs (the products
    # around the kernels may sum in another order for another layout)
    grad_rel_diff = max(rel_err(a, b_) for other in (with_copies, unpacked)
                        for a, b_ in zip(grads_now, step(other)))
    for tag, fn in (("now", lambda: block(x, train=True)), ("unpacked", unpacked),
                    ("with_copies", with_copies)):
        step(fn)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                step(fn)
            torch.cuda.synchronize()
        rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.self_device_time_total > 0), key=lambda r: -r[1])
        report[tag] = dict(
            device_ms_per_call=sum(r[1] for r in rows) / 1e3 / calls,
            copy_kernels_per_call=sum(r[2] for r in rows if "copy" in r[0].lower()) / calls,
            kernels=[dict(name=k[:90], device_ms_per_call=t / 1e3 / calls, per_call=cnt / calls)
                     for k, t, cnt in rows])
    print(json.dumps({"profile_attention_block_train": dict(
        shape=[b, side, side, c], calls=calls, grad_rel_diff=grad_rel_diff, **report)}),
          flush=True)
    assert grad_rel_diff <= K9_TOL, "the strided training route and the route with copies disagree"
    assert report["now"]["copy_kernels_per_call"] < report["with_copies"]["copy_kernels_per_call"]


def build_train(dev, family: str = "unet"):
    """The training configuration of `sgdm_tpu_torch.train` (``family``
    "unet": IN64 unet_fast; "unetca": VOC64 unetca_fast) at model batch 128
    with seeded random nonzero weights (zero-initialised output convs would
    zero every upstream gradient and the comparison would show nothing), at a
    state past the lr warmup (count 500: lr = 1e-4)."""
    from sgdm_tpu_torch import train as train_mod

    run = train_mod.build(TRAIN_BATCH, 64, family=family, init="random", seed=0, device=dev)
    st = run["state"]
    st.step = st.ema_updates = st.opt_state.count = st.opt_state.schedule_count = TRAIN_COUNT
    run["batches"] = train_mod.make_batches(2, TRAIN_BATCH, 64, run["cfg"]["cond_dim"], dev,
                                            family=family)
    return run


def phase_train(dev, card: str, family: str = "unet", agg: dict | None = None) -> dict:
    """One step kernels on vs off from one state, then the served run with
    exact launch counts (IN64: 2 warm-up + 8 timed steps; VOC64: 1 + 4);
    IN64's step is then audited (`roofline_train`, against the kernels
    phase's rows ``agg``)."""
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.models.layers import set_kernels

    tag = "" if family == "unet" else "_ca"
    per_step = TRAIN_LAUNCHES if family == "unet" else CA_TRAIN_LAUNCHES
    warmup, timed = ((TRAIN_STEPS_WARMUP, TRAIN_STEPS_TIMED) if family == "unet"
                     else (CA_TRAIN_STEPS_WARMUP, CA_TRAIN_STEPS_TIMED))
    run = build_train(dev, family)
    model, step, batches = run["model"], run["step"], run["batches"]
    state = run["state"]

    # (a) one step kernels on and one kernels off from the same state, draws and seeds
    base = state.clone()
    with full_f32():  # only the kernels differ
        set_kernels(model, True)
        s_on, m_on = step(base.clone(), batches[0], seed=0, return_grads=True)
        set_kernels(model, False)
        s_off, m_off = step(base.clone(), batches[0], seed=0, return_grads=True)
        set_kernels(model, True)
    torch.cuda.synchronize()
    g_on, g_off = m_on["grads"].double(), m_off["grads"].double()
    loss_on, loss_off = m_on["loss"].item(), m_off["loss"].item()
    leaf = {}
    for (name, _), a, b in zip(state.layout, state.unflatten(g_on).values(),
                               state.unflatten(g_off).values()):
        if b.abs().max() > 0:
            leaf[name] = rel_err(a, b)
    worst = max(leaf, key=leaf.get)
    dp = (s_on.params - s_off.params).abs().max().item()
    row = dict(loss_kernels=loss_on, loss_plain=loss_off,
               loss_rel_diff=abs(loss_on - loss_off) / abs(loss_off),
               grad_cosine=(g_on @ g_off / (g_on.norm() * g_off.norm())).item(),
               grad_norm_kernels=g_on.norm().item(), grad_norm_plain=g_off.norm().item(),
               worst_leaf=worst, worst_leaf_rel_err=leaf[worst],
               param_max_abs_diff=dp, param_rel_diff=dp / s_off.params.abs().max().item(),
               update_max_abs=max((s.params - base.params).abs().max().item()
                                  for s in (s_on, s_off)),
               adam_step_bound=adam_step_bound(base.params.abs().max().item()),
               ema_max_abs_diff=(s_on.ema_params - s_off.ema_params).abs().max().item())
    print(json.dumps({f"train{tag}_kernels_vs_plain": row}), flush=True)
    assert math.isfinite(loss_on) and row["loss_rel_diff"] <= TRAIN_LOSS_TOL, row
    assert row["grad_cosine"] >= TRAIN_GRAD_COS, row
    assert row["worst_leaf_rel_err"] <= TRAIN_LEAF_TOL, row
    assert 0 < row["update_max_abs"] <= row["adam_step_bound"], row
    assert dp <= 2 * row["adam_step_bound"], row
    del base, s_on, s_off, m_on, m_off, g_on, g_off

    # (b) the served run: counters at 0, warm-up and timed steps, counters read
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    losses = []
    total = warmup + timed
    for i in range(total):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = step(state, batches[i % len(batches)], seed=0)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = ops.launch_counts()
    losses = torch.stack(losses).float().cpu()
    want = dict({k: 0 for k in META}, **{k: total * v for k, v in per_step.items()})
    row = dict(card=card, batch=TRAIN_BATCH, steps=total, timed_steps=timed,
               s_per_step=elapsed / timed, samples_per_s=TRAIN_BATCH * timed / elapsed,
               loss_finite=bool(torch.isfinite(losses).all()), losses=losses.tolist(),
               grad_norm_last=metrics["grad_norm"].item(), launches=counts,
               launches_per_step={k: v / total for k, v in counts.items()},
               peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    print(json.dumps({f"train{tag}": row}), flush=True)
    assert row["loss_finite"], row["losses"]
    assert counts == want, f"train{tag}: launch counts {counts} != {want}"
    phase_train.s_per_step[tag] = row["s_per_step"]
    if family == "unet":
        roofline_train(step, state, batches, card, agg or {})
    return counts


phase_train.s_per_step = {}   # by family tag ("" for IN64): the timed steps' mean


def train_path_bounds() -> dict:
    """Bound ms a step of each kernel of the IN64 train step at the kernels
    phase's shapes, as that phase sums its rows."""
    b = TRAIN_BATCH
    return dict(
        resblock_train=sum(n * roofline.resblock_cost(b, h, w, ci, co, None, ci != co,
                                                      residuals=True).bound()[0]
                           for h, w, ci, co, n in K1_SHAPES),
        resblock_bwd=sum(n * roofline.resblock_bwd_cost(b, h, w, ci, co, ci != co).bound()[0]
                         for h, w, ci, co, n in K1_SHAPES),
        flash_attention_fwd=K9_CALLS * roofline.attention_cost(*K9_SHAPE, lse=True).bound()[0],
        flash_attention_bwd=K9_CALLS * roofline.attention_bwd_cost(*K9_SHAPE).bound()[0],
        adamw_ema=roofline.adamw_ema_cost(N_PARAMS_IN64).bound()[0])


def audit_rows(out: dict, top: int = 15) -> list:
    return [dict(name=r["name"][:90], calls=r["calls"], gb=r["gb"], gflop=r["gflop"], ms=r["ms"],
                 bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                 share_of_bound=r["share_of_bound"], share_of_step=r["share_of_step"],
                 **({"execs": r["execs"]} if "execs" in r else {})) for r in out["rows"][:top]]


def assert_attributed(tag: str, out: dict) -> None:
    """(a): the rows' device ms and the unattributed ms make the window's
    total device time, within 0.1 %."""
    got = out["rows_ms"] + out["unattributed"]["ms"]
    assert out["device_ms"] > 0 and abs(got - out["device_ms"]) <= 1e-3 * out["device_ms"], \
        (tag, got, out["device_ms"])


def roofline_train(step, state, batches, card: str, agg: dict) -> None:
    """`roofline.audit_train_step` over ROOFLINE_TRAIN_STEPS steps of the
    full-width IN64 train step at batch 128 (and its accounting step): (a)
    every kernel's device time in exactly one row; (b) the rows of K4, K5, K9
    fwd / bwd and K8 with TRAIN_LAUNCHES × steps calls; (c) their bounds
    those of the kernels phase at its shapes; (d) none above
    ROOFLINE_SHARE_MAX of its bound."""
    t0 = time.perf_counter()
    out = roofline.audit_train_step(step, state, batches, steps=ROOFLINE_TRAIN_STEPS, top=15,
                                    title="IN64 unet_fast train step, batch 128 — ")
    seconds = TOOLING_SECONDS["roofline_train"] = time.perf_counter() - t0
    rows = {r["name"]: r for r in out["rows"]}
    want = train_path_bounds()
    kernels = {k: dict(calls=rows[k]["calls"], gb=rows[k]["gb"], gflop=rows[k]["gflop"],
                       ms=rows[k]["ms"], bound_ms=rows[k]["bound_ms"],
                       share_of_bound=rows[k]["share_of_bound"], path_bound_ms=want[k],
                       kernels_phase_bound_ms=agg[k]["bound_ms"] if agg.get(k, {}).get("seen")
                       else None)
               for k in TRAIN_LAUNCHES if k in rows}
    print(json.dumps({"roofline_train": dict(
        card=card, seconds=seconds, steps=ROOFLINE_TRAIN_STEPS, ms_per_step=out["ms_per_step"],
        device_ms_per_step=out["device_ms"], rows_ms=out["rows_ms"],
        unattributed=out["unattributed"], written_gb_per_step=out["written_gb"],
        upper_gb_per_step=out["upper_gb"], kernels=kernels, top=audit_rows(out))}), flush=True)
    assert_attributed("roofline_train", out)
    for k, per in TRAIN_LAUNCHES.items():
        assert k in kernels, ("roofline_train: no row", k, sorted(rows))
        row = kernels[k]
        assert row["calls"] == per * ROOFLINE_TRAIN_STEPS, ("roofline_train", k, row)
        assert math.isclose(row["bound_ms"], want[k], rel_tol=1e-9), ("roofline_train", k, row)
        if row["kernels_phase_bound_ms"] is not None:
            assert math.isclose(row["kernels_phase_bound_ms"], want[k], rel_tol=1e-9), \
                ("roofline_train", k, row)
        assert row["share_of_bound"] <= ROOFLINE_SHARE_MAX, ("roofline_train", k, row)


def roofline_sample(card: str) -> None:
    """The roofline CLI in process at the served shape (full-width IN64, 64
    images, model batch 128 after the CFG doubling), cut to
    ROOFLINE_SAMPLE_STEPS DDIM steps and one traced call: K1, K2, K3 with
    exact execs (17, 4, 6 a forward), (a) and (d) as `roofline_train`'s."""
    t0 = time.perf_counter()
    out = roofline.main(["--mode", "sample", "--batch-size", str(SAMPLE_N), "--num-steps",
                         str(ROOFLINE_SAMPLE_STEPS), "--iters", "1", "--top", "15"])
    seconds = TOOLING_SECONDS["roofline_sample"] = time.perf_counter() - t0
    rows = {r["name"]: r for r in out["rows"]}
    per = {"resblock": 17, "resblock_resample": 4, "self_attention": K3_CALLS}
    kernels = {k: dict(execs=rows[k]["execs"], ms=rows[k]["ms"], bound_ms=rows[k]["bound_ms"],
                       share_of_bound=rows[k]["share_of_bound"]) for k in per if k in rows}
    print(json.dumps({"roofline_sample": dict(
        card=card, seconds=seconds, n=SAMPLE_N, ddim_steps=ROOFLINE_SAMPLE_STEPS,
        ms_per_call=out["ms_per_call"], device_ms_per_call=out["device_ms"],
        rows_ms=out["rows_ms"], unattributed=out["unattributed"],
        written_gb_per_call=out["written_gb"], upper_gb_per_call=out["upper_gb"],
        kernels=kernels, top=audit_rows(out))}), flush=True)
    assert_attributed("roofline_sample", out)
    for k, n in per.items():
        assert k in kernels, ("roofline_sample: no row", k, sorted(rows))
        assert kernels[k]["execs"] == n * ROOFLINE_SAMPLE_STEPS, ("roofline_sample", k, kernels)
        assert kernels[k]["share_of_bound"] <= ROOFLINE_SHARE_MAX, ("roofline_sample", k, kernels)


# ---------------------------------------------------------------- phase 8

def fit_launches(steps: int, image_logs: int, val_batches: int) -> dict:
    """Exact launches of a `fit` run: per train step K4 17, K5 17, K9 6 + 6
    (K8 0: the trainer takes the optax-order update, as the JAX trainer
    does); per sampling forward (FIT_IMAGELOG_CALLS sampler calls of
    FIT_IMAGELOG_STEPS DDIM steps per image log, and the params and EMA val
    loss of every val batch) K1 17, K2 4, K3 6."""
    forwards = image_logs * FIT_IMAGELOG_CALLS * FIT_IMAGELOG_STEPS + val_batches * 2
    per_step = {k: v for k, v in TRAIN_LAUNCHES.items() if k != "adamw_ema"}
    return dict(sampling_launches(forwards), **{k: steps * v for k, v in per_step.items()})


def sampling_launches(forwards: int) -> dict:
    """Exact launches of ``forwards`` IN64 sampling forwards (K1 17, K2 4, K3 6 each)."""
    return dict({k: 0 for k in META}, resblock=17 * forwards, resblock_resample=4 * forwards,
                self_attention=K3_CALLS * forwards)


def fit_cli(dev, log_dir, max_epochs: int, *extra: str):
    """`python -m sgdm_tpu_torch.main --config FIT_CONFIG …` in process, for
    ``max_epochs`` epochs (the CLI trains data.trainer.max_epochs + 1), the
    image logger's samples at FIT_IMAGELOG_STEPS."""
    from pathlib import Path

    from sgdm_tpu_torch import main as main_mod

    config = Path(__file__).resolve().parent / FIT_CONFIG
    return main_mod.main(["--config", str(config), "--device", str(dev),
                          f"data.trainer.max_epochs={max_epochs - 1}", f"log_dir={log_dir}",
                          f"model.params.num_timesteps_imagelogger={FIT_IMAGELOG_STEPS}",
                          *extra])


def step_spans(ends: list, per_epoch: int) -> list[float]:
    """Seconds per step over each epoch's steps after its first, from the
    events recorded at every step's end (device clock).  From the second
    epoch on, the previous epoch's checkpoint is being written by a
    background thread during these steps; the first epoch has none."""
    out = []
    for e in range(len(ends) // per_epoch):
        first, last = ends[e * per_epoch], ends[(e + 1) * per_epoch - 1]
        out.append(first.elapsed_time(last) / 1e3 / (per_epoch - 1))
    return out


def fit_records(run_dir, want_images: bool = True) -> dict:
    """What the run's metrics.jsonl holds, its image PNGs read back."""
    from pathlib import Path

    from sgdm_tpu_torch.generate import read_png

    recs = [json.loads(line) for line in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]
    keys = {k for r in recs for k in r}
    images = [r[k]["path"] for r in recs for k in r if isinstance(r[k], dict)]
    shapes = {tuple(read_png(p).shape) for p in images}
    losses = [r["train/loss"] for r in recs if "train/loss" in r]
    row = dict(records=len(recs), images=len(images), image_shapes=sorted(shapes),
               train_losses=losses, val_loss=[r["val/loss"] for r in recs if "val/loss" in r],
               val_loss_ema=[r["val/loss_ema"] for r in recs if "val/loss_ema" in r],
               loss_vs_t_bins=len({k for k in keys if k.startswith("loss_vs_t/")}),
               epochs_logged=sorted({r["epoch"] for r in recs if "epoch_time_sec" in r}),
               epoch_time_sec=[r["epoch_time_sec"] for r in recs if "epoch_time_sec" in r],
               peak_hbm_mib=max((r.get("peak_hbm_mib", 0) for r in recs), default=0))
    for key in ("train/loss", "val/loss", "val/loss_ema", "epoch_time_sec", "peak_hbm_mib",
                "hbm_in_use_mib"):
        assert key in keys, f"metrics.jsonl lacks {key}"
    assert row["loss_vs_t_bins"] > 0 and bool(images) == want_images, row
    assert all(len(s) == 3 for s in shapes), row
    assert all(math.isfinite(v) for v in losses + row["val_loss"] + row["val_loss_ema"]), row
    return row


def fit_trace_summaries(root, card: str, idle: dict) -> None:
    """`trace_summary.summarize` of phase fit's two traces (the trainer's
    profile=1 trace, the bare step's), each held to `trace_idle`'s reading of
    the same file, to FIT_TRACED_STEPS step marks and to K4 / K5 among its
    top 10 kernels; one `trace_summary` line."""
    t0 = time.perf_counter()
    out = {}
    for key, path in (("trainer", root / "resumed" / "profile"), ("bare", root / "bare")):
        got = trace_summary.summarize(path, 10)
        out[key] = {k: got[k] for k in ("device", "steps", "step_marks", "ms_per_step",
                                        "categories", "top", "device_idle_share", "window_ms")}
    seconds = TOOLING_SECONDS["trace_summary"] = time.perf_counter() - t0
    print(json.dumps({"trace_summary": dict(card=card, seconds=seconds, **out)}), flush=True)
    for key, got in out.items():
        assert got["device_idle_share"] == idle[key]["device_idle_share"], (key, got, idle[key])
        assert got["steps"] == FIT_TRACED_STEPS, (key, got["steps"])
        names = [r["name"] for r in got["top"]]
        assert any("conv_kernel" in n for n in names), (key, "no K4 / K5 conv_kernel", names)
        assert any("wgrad_kernel" in n or "gn_bwd_kernel" in n for n in names), \
            (key, "no K5 kernel", names)


def timed_make_train_step(ends: list):
    """`make_train_step` whose steps each record a CUDA event at their end
    into ``ends`` (the trainer's s/step by `step_spans`)."""
    import torch

    from sgdm_tpu_torch.training.state import make_train_step

    def factory(*a, **k):
        step = make_train_step(*a, **k)

        def timed(state, batch, **kw):
            out = step(state, batch, **kw)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
            return out

        return timed

    return factory


def bare_steps(tr, dev, spe: int, rounds: int):
    """The bare `make_train_step(fused_optim=False)` on a fitted trainer's
    model, a copy of its state and the first ``spe`` batches of epoch 0,
    ``rounds`` times over.  Returns (s/step spans, state, batches, step)."""
    import torch

    from sgdm_tpu_torch.training.state import make_train_step

    bare = make_train_step(tr.model, tr.diffusion, tr.tx, cond_drop_prob=0.1,
                           ema_decay=tr.ema_decay, fused_optim=False, device=dev)
    dl = tr.datamodule.train_dataloader()
    dl.set_epoch(0)
    batches = [tr._device_batch(raw) for raw, _ in zip(dl, range(spe))]
    state = tr.state.clone()
    spans = []
    for _ in range(rounds):
        ends = []
        for b in batches:
            state, _ = bare(state, b, seed=0)
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
        torch.cuda.synchronize()
        spans += step_spans(ends, spe)
    return spans, state, batches, bare


def phase_fit(dev, card: str) -> dict:
    """The trainer path at full IN64 width (FIT_CONFIG: unet_fast, cond_dim
    1000, batch 128, bf16, seeded random nonzero weights): a straight fit
    of FIT_EPOCHS epochs; a fit of FIT_EPOCHS - 1 epochs resumed by a fresh
    trainer from ckpts/last for the last one; a checkpoint save / restore
    round trip held bit for bit; the bare train step on the same batches;
    `generate --run` on the resumed run.  Launch counts exact throughout."""
    import shutil
    from pathlib import Path
    from unittest import mock

    import torch

    from sgdm_tpu_torch import generate as generate_mod
    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.generate import read_png
    from sgdm_tpu_torch.models.factory import init_random_params
    from sgdm_tpu_torch.training import checkpoints as ckpt_mod
    from sgdm_tpu_torch.training import trainer as trainer_mod

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "fit"
    shutil.rmtree(root, ignore_errors=True)
    ends: list = []
    spe, epochs = FIT_STEPS_PER_EPOCH, FIT_EPOCHS
    paths = {}
    # seeded random nonzero weights (the training init zeroes the output
    # convs, and the gradients upstream of them would be zero)
    with mock.patch.object(trainer_mod, "init_train_params", init_random_params), \
            mock.patch.object(trainer_mod, "make_train_step", timed_make_train_step(ends)):
        # (a) straight
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tr_a = fit_cli(dev, root / "straight", epochs)
        torch.cuda.synchronize()
        fit_seconds = time.perf_counter() - t0
        paths["fit"] = counts = ops.launch_counts()
        want = fit_launches(epochs * spe, epochs * spe // FIT_VIS_EVERY, epochs * FIT_VAL_BATCHES)
        assert counts == want, f"fit: launch counts {counts} != {want}"
        spans = step_spans(ends, spe)
        records = fit_records(root / "straight")
        assert records["epochs_logged"] == list(range(epochs)), records
        assert tr_a.state.step == tr_a.global_step == epochs * spe
        straight_params = tr_a.state.params.clone()
        meta_a = json.loads((root / "straight" / "ckpts" / "meta.json").read_text())
        assert meta_a["last_epoch"] == epochs - 1, meta_a

        # (b) the bare train step on the same model, state and batches
        bare_spans, state, batches, bare = bare_steps(tr_a, dev, spe, 2)
        # the bare step's device idle share under the profiler (2 steps, each
        # marked), as the trainer's is read from its profile=1 trace below
        with profiling.trace(root / "bare", dev) as prof:
            for i, b in enumerate(batches[2:]):
                if i:
                    prof.step()
                state, _ = bare(state, b, seed=0)
        bare_idle = trace_idle(root / "bare")

        # (c) checkpoint save and restore, timed, held bit for bit
        cm = ckpt_mod.CheckpointManager(root / "ckpt_timing")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cm.save_last(state, 0)
        copy_s = time.perf_counter() - t0
        cm.wait_until_finished()
        save_s = time.perf_counter() - t0
        nbytes = (Path(cm.meta["last_path"]) / ckpt_mod.STATE_FILE).stat().st_size
        template = state.clone()
        for t in (template.params, template.ema_params, template.opt_state.mu,
                  template.opt_state.nu):
            t.zero_()
        template.step = template.ema_updates = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cm.restore(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        exact = (all(torch.equal(a, b) for a, b in (
            (template.params, state.params), (template.ema_params, state.ema_params),
            (template.opt_state.mu, state.opt_state.mu), (template.opt_state.nu, state.opt_state.nu)))
            and (template.step, template.ema_updates, template.opt_state.count,
                 template.opt_state.schedule_count)
            == (state.step, state.ema_updates, state.opt_state.count, state.opt_state.schedule_count))
        ckpt_row = dict(bytes=nbytes, host_copy_s=copy_s, save_s=save_s, restore_s=restore_s,
                        round_trip_bit_exact=exact)
        del tr_a, state, template, batches, bare, cm

        # (d) FIT_EPOCHS - 1 epochs, then a fresh trainer resumed from
        # ckpts/last.  The first run has profile=1: the trainer traces steps
        # 2-3 of epoch 1 (its image log is off, so the trace holds train
        # steps only)
        ops.reset_launch_counts()
        tr_b = fit_cli(dev, root / "resumed", epochs - 1, "profile=true",
                       "data.vis_every_iter=1000000000")
        paths["fit_first"] = counts = ops.launch_counts()
        want = fit_launches((epochs - 1) * spe, 0, (epochs - 1) * FIT_VAL_BATCHES)
        assert counts == want, f"fit_first: launch counts {counts} != {want}"
        fit_idle = trace_idle(root / "resumed" / "profile")
        if dev.type == "cuda":
            fit_trace_summaries(root, card, dict(trainer=fit_idle, bare=bare_idle))
        del tr_b
        ops.reset_launch_counts()
        tr_c = fit_cli(dev, root / "resumed", epochs,
                       f"resume_from={root / 'resumed' / 'ckpts' / 'last'}")
        paths["fit_resumed"] = counts = ops.launch_counts()
        want = fit_launches(spe, spe // FIT_VIS_EVERY, FIT_VAL_BATCHES)
        assert counts == want, f"fit_resumed: launch counts {counts} != {want}"

    recs = [json.loads(line) for line in
            (root / "resumed" / "metrics.jsonl").read_text().splitlines()]
    resumed_epochs = sorted({r["epoch"] for r in recs if "epoch_time_sec" in r})
    assert resumed_epochs == list(range(epochs)), resumed_epochs  # epoch 2 once, after 0 and 1
    assert tr_c.global_step == tr_c.state.step == epochs * spe, tr_c.global_step
    resume_diff = ((tr_c.state.params - straight_params).abs().max()
                   / straight_params.abs().max()).item()
    del tr_c, straight_params

    # (e) generate --run on the resumed run: 64 images, 50 steps, EMA, the run's cond_scale
    sample_s = []
    real_generate = generate_mod.generate

    def timed_generate(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_generate(*a, **k)
        torch.cuda.synchronize()
        sample_s.append(time.perf_counter() - t0)
        return out

    out_dir = root / "samples"
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(generate_mod, "generate", timed_generate):
        generate_mod.main(["--run", str(root / "resumed"), "--n", str(SAMPLE_N), "--steps",
                           str(FIT_IMAGELOG_STEPS), "--out", str(out_dir), "--device", str(dev)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    paths["generate_run"] = counts = ops.launch_counts()
    want = sampling_launches(FIT_IMAGELOG_STEPS)
    assert counts == want, f"generate_run: launch counts {counts} != {want}"
    pngs = sorted(out_dir.glob("*.png"))
    back = [read_png(p) for p in pngs[:4]]
    assert len(pngs) == SAMPLE_N and all(b.ndim == 3 and b.shape[2] == 3 for b in back), len(pngs)
    assert all(b.std() > 0 for b in back), "constant images"
    shutil.rmtree(root, ignore_errors=True)

    s_step, bare_step = sum(spans) / len(spans), sum(bare_spans) / len(bare_spans)
    print(json.dumps({"fit": dict(
        card=card, batch=TRAIN_BATCH, epochs=epochs, steps_per_epoch=spe,
        seconds=fit_seconds, s_per_step=s_step, samples_per_s=TRAIN_BATCH / s_step,
        s_per_step_by_epoch=spans, first_epoch_over_bare=spans[0] / bare_step,
        bare_s_per_step=bare_step,
        bare_samples_per_s=TRAIN_BATCH / bare_step, bare_s_per_step_by_round=bare_spans,
        trainer_over_bare=s_step / bare_step, launches=paths["fit"], records=records,
        profiled_trainer=fit_idle, profiled_bare=bare_idle)}),
        flush=True)
    print(json.dumps({"fit_checkpoint": dict(card=card, **ckpt_row)}), flush=True)
    print(json.dumps({"fit_resume": dict(
        card=card, epochs_logged=resumed_epochs, global_step=epochs * spe,
        launches_first=paths["fit_first"], launches_resumed=paths["fit_resumed"],
        final_params_rel_diff_vs_straight=resume_diff)}), flush=True)
    print(json.dumps({"generate_run": dict(
        card=card, n=SAMPLE_N, steps=FIT_IMAGELOG_STEPS, cli_seconds=cli_s,
        sample_seconds=sample_s[0], ddim_steps_per_s=FIT_IMAGELOG_STEPS / sample_s[0],
        pngs=len(pngs), read_back=len(back), launches=counts)}), flush=True)
    print(json.dumps({"fit_phase": dict(card=card, seconds=time.perf_counter() - t_phase)}),
          flush=True)
    assert exact, ckpt_row
    if dev.type == "cuda":
        assert fit_idle["device_events"] and bare_idle["device_events"], (fit_idle, bare_idle)
    return paths


# ---------------------------------------------------------------- phase 8b

def write_in64p_tree(root, seed: int = 0) -> dict:
    """A downsampled-ImageNet 64-px tree in Chrabaszcz's format under
    ``root/pickles/size64`` (uint8 CHW rows, labels 1..1000), the port's
    in64pickle.h5 pack of it moved to ``root/pack/size64``, and a k = 5000
    cluster h5 with its name2id .json written by the port's HDF5 writer."""
    import pickle

    import numpy as np

    from sgdm_tpu_torch.data.imagenet_pickle import ImageNetPickle
    from sgdm_tpu_torch.utils import h5

    rng = np.random.default_rng(seed)
    row = 3 * 64 * 64
    sized = root / "pickles" / "size64"
    sized.mkdir(parents=True)
    t0 = time.perf_counter()
    for i in range(1, IN64P_TRAIN_FILES + 1):
        with open(sized / f"train_data_batch_{i}", "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (IN64P_PER_FILE, row), np.uint8),
                         "labels": rng.integers(1, IN64P_CLASSES + 1, IN64P_PER_FILE).tolist(),
                         "mean": np.zeros(row)}, f, protocol=4)
    with open(sized / "val_data", "wb") as f:
        pickle.dump({"data": rng.integers(0, 256, (IN64P_VAL, row), np.uint8),
                     "labels": rng.integers(1, IN64P_CLASSES + 1, IN64P_VAL).tolist()}, f,
                    protocol=4)
    pickles_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pack = ImageNetPickle.pickle_to_h5(str(root / "pickles"), 64)
    pack_s = time.perf_counter() - t0
    (root / "pack" / "size64").mkdir(parents=True)
    pack = pack.rename(root / "pack" / "size64" / pack.name)
    n_train = IN64P_TRAIN_FILES * IN64P_PER_FILE
    t0 = time.perf_counter()
    with h5.File(root / "cluster5000.h5", "w") as f:
        f.create_dataset("train", data=rng.integers(0, IN64P_K, n_train))
        f.create_dataset("val", data=rng.integers(0, IN64P_K, IN64P_VAL))
        f.create_dataset("centroids",
                         data=rng.standard_normal((IN64P_K, IN64P_FEAT)).astype(np.float32))
        f.create_dataset("all_attributes", (1,)).attrs["cluster_k"] = IN64P_K
    # the reader's id2name is "{i}.jpg" in both splits: the rows in dataset order
    (root / "cluster5000.json").write_text(json.dumps(
        {"name2id": {f"{i}.jpg": i for i in range(n_train)}}))
    cluster_s = time.perf_counter() - t0
    return dict(pickles_s=pickles_s, pack_s=pack_s, cluster_h5_s=cluster_s,
                pickle_bytes=sum(p.stat().st_size for p in sized.iterdir()),
                pack_bytes=pack.stat().st_size,
                cluster_h5_bytes=(root / "cluster5000.h5").stat().st_size)


def same_batch(a: dict, b: dict) -> bool:
    """Equal keys, dtypes, shapes and bits."""
    import numpy as np

    bits = lambda v: np.ascontiguousarray(v).view(np.uint8)
    return list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and np.array_equal(bits(a[k]), bits(b[k])) for k in a)


def phase_fit_in64p(dev, card: str) -> dict:
    """The IN64 self-labeled run on its own data (module docstring, 8b)."""
    import shutil
    from pathlib import Path
    from unittest import mock

    import numpy as np
    import torch

    from sgdm_tpu_torch import main as main_mod
    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.data.imagenet_pickle import ImageNetPickle
    from sgdm_tpu_torch.data.loader import _collate
    from sgdm_tpu_torch.models.factory import init_random_params
    from sgdm_tpu_torch.native import gather_image_batch, gather_image_batch_plain
    from sgdm_tpu_torch.training import trainer as trainer_mod

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "fit_in64p"
    shutil.rmtree(root, ignore_errors=True)
    written = write_in64p_tree(root)
    h5_file = str(root / "cluster5000.h5")

    # (a) the three batch routes and the two gathers, bit for bit
    kw = dict(train=True, image_size=64, h5_file=h5_file, condition_method="cluster",
              num_classes=IN64P_CLASSES)
    by_root = {r: ImageNetPickle(str(root / r), **kw) for r in ("pickles", "pack")}
    pack_rows = by_root["pack"].data   # a read-only view of the file's mapping
    assert not pack_rows.flags.owndata and not pack_rows.flags.writeable
    assert by_root["pack"].cond.cluster_k == IN64P_K
    idx = np.random.default_rng(1).permutation(len(by_root["pack"]))[:TRAIN_BATCH]
    got = {r: ds.get_batch(idx) for r, ds in by_root.items()}
    got["getitem"] = _collate([by_root["pack"][int(i)] for i in idx])
    routes_equal = (same_batch(got["pickles"], got["pack"])
                    and same_batch(got["pack"], got["getitem"]))
    assert set(got["pack"]) == {"image", "img4unsup", "id", "label_id", "label", "label_random",
                                "cluster", "cluster_id", "cluster_random"}, sorted(got["pack"])
    assert got["pack"]["cluster"].shape == (TRAIN_BATCH, IN64P_K)
    native, native_u8 = gather_image_batch(by_root["pack"].data, idx, 64)
    plain, plain_u8 = gather_image_batch_plain(by_root["pack"].data, idx, 64)
    gathers_equal = (np.array_equal(native.view(np.uint32), plain.view(np.uint32))
                     and np.array_equal(native_u8, plain_u8))

    # (b) get_batch images/s on each root, the gather alone, the lookups
    batches = np.random.default_rng(2).integers(0, len(by_root["pack"]),
                                                (IN64P_TIMED_BATCHES + 1, TRAIN_BATCH))
    rates, gather_ms = {}, {}
    for r, ds in by_root.items():
        ds.get_batch(batches[0])
        t0 = time.perf_counter()
        for b in batches[1:]:
            ds.get_batch(b)
        rates[r] = IN64P_TIMED_BATCHES * TRAIN_BATCH / (time.perf_counter() - t0)
        for name, fn in (("native", gather_image_batch), ("numpy", gather_image_batch_plain)):
            t0 = time.perf_counter()
            for b in batches[1:]:
                fn(ds.data, b, 64)
            gather_ms[f"{r}_{name}"] = (time.perf_counter() - t0) * 1e3 / IN64P_TIMED_BATCHES
    cond = by_root["pack"].cond
    t0 = time.perf_counter()
    for i in batches[1:].ravel():
        cond.get(int(i))
    lookup_us = (time.perf_counter() - t0) * 1e6 / batches[1:].size
    data_row = dict(card=card, **written, train_images=len(by_root["pack"]),
                    routes_bit_identical=routes_equal, gathers_bit_identical=gathers_equal,
                    get_batch_images_per_s=rates, gather_ms_per_batch=gather_ms,
                    lookup_us_per_sample=lookup_us, batch=TRAIN_BATCH, cluster_k=IN64P_K)
    print(json.dumps({"fit_in64p_data": data_row}), flush=True)
    assert routes_equal and gathers_equal, data_row
    del by_root, got

    # (c) the CLI on the pack, the trainer's steps timed by CUDA events
    ends: list = []
    spe, epochs = IN64P_STEPS, IN64P_EPOCHS
    config = Path(__file__).resolve().parent / IN64P_CONFIG
    with mock.patch.object(trainer_mod, "init_train_params", init_random_params), \
            mock.patch.object(trainer_mod, "make_train_step", timed_make_train_step(ends)):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tr = main_mod.main([
            "--config", str(config), "--device", str(dev), f"data.root={root / 'pack'}",
            f"data.h5_file={h5_file}", f"data.params.batch_size={TRAIN_BATCH}",
            f"pl.trainer.limit_train_batches={spe}",
            f"pl.trainer.limit_val_batches={IN64P_VAL_BATCHES}",
            f"data.vis_every_iter={epochs * spe}",
            f"model.params.num_timesteps_imagelogger={FIT_IMAGELOG_STEPS}",
            "pl.trainer.log_every_n_steps=2", "data.fid_train_image_dir=null",
            "data.fid_val_image_dir=null", f"data.trainer.max_epochs={epochs - 1}",
            f"log_dir={root / 'run'}"])
        torch.cuda.synchronize()
        fit_seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
    want = fit_launches(epochs * spe, 1, epochs * IN64P_VAL_BATCHES)
    assert counts == want, f"fit_in64p: launch counts {counts} != {want}"
    spans = step_spans(ends, spe)
    records = fit_records(root / "run")
    assert records["epochs_logged"] == list(range(epochs)), records
    assert tr.state.step == tr.global_step == epochs * spe
    assert tr.datamodule.datasets["train"].cond.cluster_k == IN64P_K

    # (d) the bare train step on the trainer's model, state and first batches
    bare_spans = bare_steps(tr, dev, spe, epochs)[0]
    del tr
    shutil.rmtree(root, ignore_errors=True)

    s_step, bare_step = sum(spans) / len(spans), sum(bare_spans) / len(bare_spans)
    print(json.dumps({"fit_in64p": dict(
        card=card, batch=TRAIN_BATCH, cond_dim=IN64P_K, epochs=epochs, steps_per_epoch=spe,
        seconds=fit_seconds, s_per_step=s_step, samples_per_s=TRAIN_BATCH / s_step,
        s_per_step_by_epoch=spans, bare_s_per_step=bare_step,
        bare_s_per_step_by_round=bare_spans, trainer_over_bare=s_step / bare_step,
        trainer_over_bare_by_epoch=[v / bare_step for v in spans],
        get_batch_rate_over_step_rate=rates["pack"] * s_step / TRAIN_BATCH,
        launches=counts, records=records,
        phase_seconds=time.perf_counter() - t_phase)}), flush=True)
    return {"fit_in64p": counts}


def write_feat_h5(path, seed: int = 0) -> None:
    """A labelled, separable feat h5 (the feat extractor's layout: train / val
    rows and labels, all_attributes) of RUNBOOK_K classes around seeded random
    centres, by the port's HDF5 writer."""
    import numpy as np

    from sgdm_tpu_torch.utils import h5

    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((RUNBOOK_K, RUNBOOK_DIM), dtype=np.float32)
    with h5.File(path, "w") as f:
        for split, n in (("train", RUNBOOK_ROWS), ("val", RUNBOOK_VAL)):
            labels = np.arange(n) % RUNBOOK_K
            noise = rng.standard_normal((n, RUNBOOK_DIM), dtype=np.float32)
            f.create_dataset(split, data=centres[labels] + 0.05 * noise)
            f.create_dataset(f"{split}_labels", data=labels)
        attrs = f.create_dataset("all_attributes", (1,)).attrs
        attrs["dataset_name"], attrs["feat_from"] = "synthetic", "dino_vitb16"
        attrs["feat_dim"], attrs["is_grey"] = RUNBOOK_DIM, 0


def runbook_check(dev, card: str) -> None:
    """`parity_runbook.main` with no weights and no dataset: every stage but
    cluster SKIPs, naming its artifact; the cluster stage (k = RUNBOOK_K on
    `write_feat_h5`'s features) PASSes at the NMI floor 0.50 and FAILs with
    exit code 1 at 1.01."""
    import os
    import shutil
    from pathlib import Path
    from unittest import mock

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "runbook"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    write_feat_h5(root / "feat.h5")
    base = ["--out-root", str(root), "--data-root", str(root / "no_dataset"), "--feat-h5",
            str(root / "feat.h5"), "--k", str(RUNBOOK_K), "--device", str(dev)]
    needs = {"weights/dino_vitb16": "$SGDM_DINO_VITB16", "weights/dino_vits16": "$SGDM_DINO_VITS16",
             "weights/clip": "$SGDM_CLIP_WEIGHTS", "feat": "dataset not mounted",
             "inception": "$SGDM_INCEPTION_WEIGHTS", "fid": "--fid-dir1"}
    env = {k: v for k, v in os.environ.items() if not k.startswith("SGDM_")}
    with mock.patch.dict(os.environ, env, clear=True):
        summary = parity_runbook.main(["--stage", "all", *base])
        try:
            parity_runbook.main(["--stage", "cluster", *base, "--nmi-floor", "1.01"])
            code = 0
        except SystemExit as e:
            code = e.code
    shutil.rmtree(root, ignore_errors=True)
    seconds = TOOLING_SECONDS["parity_runbook"] = time.perf_counter() - t0
    results = {r["stage"]: r for r in summary["parity_runbook"]}
    print(json.dumps({"parity_runbook": dict(
        card=card, seconds=seconds, rows=RUNBOOK_ROWS, dim=RUNBOOK_DIM, k=RUNBOOK_K,
        status={s: r["status"] for s, r in results.items()}, nmi=results["cluster"]["value"],
        failed=summary["failed"], exit_code_at_floor_1_01=code)}), flush=True)
    for stage, need in needs.items():
        assert results[stage]["status"] == "SKIPPED" and need in results[stage]["detail"], \
            results[stage]
    assert results["cluster"]["status"] == "PASS" and summary["failed"] == 0, results["cluster"]
    assert code == 1, f"the runbook at NMI floor 1.01 exited {code}"


# ---------------------------------------------------------------- phases 8c-8e

def fixture_bytes(name: str) -> bytes:
    from pathlib import Path

    return (Path(__file__).resolve().parent / JPEG_FIXTURES / f"{name}.jpg").read_bytes()


def id_masks(rng, h: int, w: int, n: int, classes: int, cell: int = 25):
    """``n`` uint8 id masks [h, w]: ids drawn per ``cell``-pixel square,
    255 (the ignore label) on a 3-pixel frame and where the ids change."""
    import numpy as np

    out = []
    for _ in range(n):
        m = rng.integers(0, classes, (h // cell + 1, w // cell + 1)).astype(np.uint8)
        m = np.repeat(np.repeat(m, cell, 0), cell, 1)[:h, :w].copy()
        edge = np.zeros((h, w), bool)
        edge[1:] |= m[1:] != m[:-1]
        edge[:, 1:] |= m[:, 1:] != m[:, :-1]
        m[edge] = 255
        m[:3], m[-3:], m[:, :3], m[:, -3:] = 255, 255, 255, 255
        out.append(m)
    return out


def png_bytes(img) -> bytes:
    """A grey PNG's bytes by the port's writer (each distinct mask is
    encoded once and its bytes copied under every name that uses it)."""
    import tempfile
    from pathlib import Path

    from sgdm_tpu_torch.utils.png import write_png

    with tempfile.TemporaryDirectory() as d:
        write_png(Path(d) / "m.png", img)
        return (Path(d) / "m.png").read_bytes()


def write_voc_tree(root, n_train: int, n_val: int, seed: int = 0) -> dict:
    """A VOC 2012-aug tree under ``root``: ``JPEGImages/<name>.jpg`` (the
    VOC-size fixtures' bytes, fixture i % 4 under name i),
    ``SegmentationClassAug/<name>.png`` (VOC_MASKS distinct grey id masks,
    ids 0..20 and 255, 4 a fixture size), ``ImageSets/SegmentationAug/
    train_aug.txt`` and ``val.txt``; a k = VOC_K cluster h5 keyed by image
    name (``cluster.h5`` + ``cluster.json``) and a LOST h5 (``lost.h5``: a
    box and a cluster id a name) by the port's HDF5 writer."""
    import numpy as np

    from sgdm_tpu_torch.utils import h5
    from sgdm_tpu_torch.utils.jpeg import jpeg_header

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    jpegs = [fixture_bytes(f) for f in VOC_FIXTURES]
    sizes = [jpeg_header(b)[:2] for b in jpegs]          # (w, h)
    per = VOC_MASKS // len(jpegs)
    masks = [png_bytes(m) for w, h in sizes for m in id_masks(rng, h, w, per, 21)]
    for d in ("JPEGImages", "SegmentationClassAug", "ImageSets/SegmentationAug"):
        (root / d).mkdir(parents=True, exist_ok=True)
    names = [f"2012_{i:06d}" for i in range(n_train + n_val)]
    boxes = []
    for i, n in enumerate(names):
        f = i % len(jpegs)
        (root / "JPEGImages" / f"{n}.jpg").write_bytes(jpegs[f])
        (root / "SegmentationClassAug" / f"{n}.png").write_bytes(
            masks[f * per + (i // len(jpegs)) % per])
        w, h = sizes[f]
        x0, y0 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
        boxes.append([x0, y0, x0 + int(rng.integers(16, w // 2)), y0 + int(rng.integers(16, h // 2))])
    (root / "ImageSets/SegmentationAug/train_aug.txt").write_text("\n".join(names[:n_train]) + "\n")
    (root / "ImageSets/SegmentationAug/val.txt").write_text("\n".join(names[n_train:]) + "\n")
    with h5.File(root / "cluster.h5", "w") as f:
        f.create_dataset("train", data=rng.integers(0, VOC_K, n_train))
        f.create_dataset("val", data=rng.integers(0, VOC_K, n_val))
        f.create_dataset("all_attributes", (1,)).attrs["cluster_k"] = VOC_K
    # one name2id for both splits: the row of each name within its split
    (root / "cluster.json").write_text(json.dumps({"name2id": {
        f"{n}.jpg": i if i < n_train else i - n_train for i, n in enumerate(names)}}))
    with h5.File(root / "lost.h5", "w") as f:
        for n, box in zip(names, boxes):
            f.create_dataset(f"{n}.jpg_bbox", data=np.asarray(box, np.int64))
            f.create_dataset(f"{n}.jpg_clusterid", data=np.int64(rng.integers(0, VOC_K)))
    return dict(names=len(names), seconds=time.perf_counter() - t0,
                bytes=sum(p.stat().st_size for p in root.rglob("*") if p.is_file()))


def write_coco_tree(root, n_train: int, n_val: int, seed: int = 0) -> dict:
    """A COCO-Stuff tree (STEGO's layout) under ``root``: ``images/
    {train,val}2017/<stem>.jpg`` (the COCO-size fixtures' bytes, the grey
    480x640 one every other name), ``annotations/{split}2017/<stem>.png``
    (fine ids 0..181 and 255, 8 distinct a size), a ``fine_to_coarse_dict
    .pickle`` (182 → 27, seeded) and ``stego/<stem>.png`` (k = COCO_K
    masks, 8 distinct a size)."""
    import pickle

    import numpy as np

    from sgdm_tpu_torch.utils.jpeg import jpeg_header

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    jpegs = [fixture_bytes(f) for f in COCO_FIXTURES]
    sizes = [jpeg_header(b)[:2] for b in jpegs]
    anns = [[png_bytes(m) for m in id_masks(rng, h, w, 8, 182)] for w, h in sizes]
    stego = [[png_bytes(m) for m in id_masks(rng, h, w, 8, COCO_K, cell=40)] for w, h in sizes]
    coarse = rng.integers(0, 27, 182)
    coarse[:27] = np.arange(27)                    # every coarse class has a fine one
    with open(root / "fine_to_coarse_dict.pickle", "wb") as f:
        pickle.dump({"fine_index_to_coarse_index": {i: int(c) for i, c in enumerate(coarse)}}, f)
    (root / "stego").mkdir(parents=True)
    i = 0
    for split, n in (("train", n_train), ("val", n_val)):
        for d in ("images", "annotations"):
            (root / d / f"{split}2017").mkdir(parents=True)
        for _ in range(n):
            stem, f = f"{i:012d}", i % len(jpegs)
            (root / "images" / f"{split}2017" / f"{stem}.jpg").write_bytes(jpegs[f])
            (root / "annotations" / f"{split}2017" / f"{stem}.png").write_bytes(
                anns[f][(i // 2) % 8])
            (root / "stego" / f"{stem}.png").write_bytes(stego[f][(i // 3) % 8])
            i += 1
    return dict(names=i, seconds=time.perf_counter() - t0,
                bytes=sum(p.stat().st_size for p in root.rglob("*") if p.is_file()))


def phase_images(card: str) -> dict:
    """The JPEG decoder and PIL's resamplers on the card's host (module
    docstring, 8c)."""
    import itertools
    import os
    import shutil
    from pathlib import Path

    import numpy as np

    from sgdm_tpu_torch.data import transforms
    from sgdm_tpu_torch.data.loader import DataLoader
    from sgdm_tpu_torch.data.voc12 import VOCSegmentation
    from sgdm_tpu_torch.utils.image import read_image
    from sgdm_tpu_torch.utils.jpeg import decode_jpeg
    from sgdm_tpu_torch.utils.png import read_png, unfilter

    here = Path(__file__).resolve().parent
    fix = here / JPEG_FIXTURES
    names = sorted(p.stem for p in fix.glob("*.jpg"))
    # (a) every fixture against PIL's decode, committed beside it
    fixtures_bad = []
    for n in names:
        want = read_png(fix / f"{n}.png", samples=True)
        got = decode_jpeg((fix / f"{n}.jpg").read_bytes(), "L" if want.ndim == 2 else "RGB")
        if got.shape != want.shape or not np.array_equal(got, want):
            fixtures_bad.append(n)
    # (b) the native resamplers, the datasets' chain and the PNG unfilters
    # against their numpy versions
    rng = np.random.default_rng(0)
    resample_bad = []
    for shape, (oh, ow), name in [
            ((375, 500, 3), (260, 346), "bilinear"), ((375, 500, 3), (300, 300), "bilinear"),
            ((500, 375, 3), (320, 240), "bilinear"), ((480, 640), (320, 320), "bilinear"),
            ((60, 90, 3), (235, 352), "bilinear"), ((224, 224, 3), (64, 64), "bicubic"),
            ((224, 224), (64, 64), "bicubic"), ((23, 37, 3), (64, 41), "bicubic")]:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        fn = getattr(transforms, f"resize_{name}")
        if not np.array_equal(fn(img, oh, ow), fn(img, oh, ow, plain=True)):
            resample_bad.append(f"{name} {shape} -> {(oh, ow)}")
    img = rng.integers(0, 256, (375, 500, 3), dtype=np.uint8)
    chain = [transforms.scale_crop_resize(img, 260, 346, 17, 101, 224, 64, unsup=300,
                                          plain=plain) for plain in (False, True)]
    if not all(np.array_equal(a, b) for a, b in zip(*chain)):
        resample_bad.append("scale_crop_resize")
    unfilter_bad = []
    for bpp in (1, 3, 4):
        raw = rng.integers(0, 256, (64, 1 + 97 * bpp), dtype=np.uint8)
        for kind in (0, 1, 2, 3, 4, None):
            raw[:, 0] = rng.integers(0, 5, 64) if kind is None else kind
            if not np.array_equal(unfilter(raw, 64, 97 * bpp, bpp),
                                  unfilter(raw, 64, 97 * bpp, bpp, plain=True)):
                unfilter_bad.append(f"filter {kind} bpp {bpp}")

    # (c) times on this host: a decode, the resizes, one __getitem__
    def ms(fn, n=IMAGES_TIMED):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n

    voc, coco = (fix / "voc_500x375_a.jpg").read_bytes(), (fix / "coco_640x480.jpg").read_bytes()
    decoded = decode_jpeg(voc)
    times = dict(decode_voc_500x375_420=ms(lambda: decode_jpeg(voc)),
                 decode_coco_640x480_420=ms(lambda: decode_jpeg(coco)),
                 scale_crop_resize_with_unsup=ms(lambda: transforms.scale_crop_resize(
                     decoded, 260, 346, 17, 101, 224, 64, unsup=300)),
                 scale_crop_resize_plain=ms(lambda: transforms.scale_crop_resize(
                     decoded, 260, 346, 17, 101, 224, 64, unsup=300, plain=True), 2))
    root = here / "build" / "images"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    write_voc_tree(root, 5 * TRAIN_BATCH, 8)
    ds = VOCSegmentation(str(root), condition_method="clusterlayout",
                         condition={"clusterlayout": {"how": "lost"}},
                         h5_file=str(root / "cluster.h5"), lost_file=str(root / "lost.h5"))
    index = itertools.count()
    times["getitem_voc_lost"] = ms(lambda: ds[next(index) % len(ds)])
    times["read_image_and_mask"] = ms(lambda: (read_image(ds.images[0]),
                                               read_png(ds.masks[0], samples=True)))
    # what is left of __getitem__ past the native calls and the mask read:
    # Python under the interpreter lock (and the one-hots' numpy)
    times["getitem_rest"] = (times["getitem_voc_lost"] - times["read_image_and_mask"]
                             - times["scale_crop_resize_with_unsup"])
    # the train loader's images/s (batch 128, batches 2-5) by thread count
    threads = {}
    for nw in READER_THREADS:
        threads[nw] = loader_rate(DataLoader(ds, TRAIN_BATCH, shuffle=True, num_workers=nw),
                                  4)[1]
    shutil.rmtree(root, ignore_errors=True)
    row = dict(card=card, cpu_count=os.cpu_count(), fixtures=len(names),
               fixtures_bit_identical=not fixtures_bad, fixtures_mismatched=fixtures_bad,
               resamplers_bit_identical=not resample_bad, resample_mismatched=resample_bad,
               unfilters_bit_identical=not unfilter_bad, unfilter_mismatched=unfilter_bad,
               ms=times, loader_images_per_s_by_threads=threads)
    print(json.dumps({"images": row}), flush=True)
    assert len(names) == 16 and not fixtures_bad and not resample_bad and not unfilter_bad, row
    return row


def loader_rate(dl, batches: int) -> tuple[dict, float]:
    """(the first batch, images/s over the next ``batches`` of them, at most
    the epoch's): the first batch waits on the pool's start, the later ones
    on the reader's pace."""
    it = iter(dl)
    first = next(it)
    n = min(batches, len(dl) - 1)
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    rate = n * dl.batch_size / (time.perf_counter() - t0)
    it.close()
    return first, rate


def seg_fit_launches(steps: int, image_logs: int, val_batches: int) -> dict:
    """Exact launches of a VOC64 / COCO-Stuff64 `unetca_fast` fit: per train
    step K4 17, K5 17 (K7 0: training attention takes the einsum; K8 0: the
    optax-order update); per sampling forward (image logs as `fit_launches`,
    the params and EMA val loss of every val batch) K1 17, K7 6."""
    forwards = image_logs * FIT_IMAGELOG_CALLS * FIT_IMAGELOG_STEPS + val_batches * 2
    out = {k: 0 for k in META}
    out.update({k: forwards * v for k, v in CA_SAMPLE_LAUNCHES.items()})
    out.update({k: steps * v for k, v in CA_TRAIN_LAUNCHES.items() if k != "adamw_ema"})
    return out


def phase_fit_seg(dev, card: str, run: str) -> dict:
    """``run`` "fit_voc64_lost" or "fit_coco64_stego": the README's
    segmentation run through the CLI on its written tree (module
    docstring, 8d / 8e)."""
    import shutil
    from pathlib import Path
    from unittest import mock

    import torch

    from sgdm_tpu_torch import generate as generate_mod
    from sgdm_tpu_torch import main as main_mod
    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.models.factory import init_random_params
    from sgdm_tpu_torch.utils.png import read_png
    from sgdm_tpu_torch.training import trainer as trainer_mod

    t_phase = time.perf_counter()
    voc = run == "fit_voc64_lost"
    here = Path(__file__).resolve().parent
    root = here / "build" / run
    shutil.rmtree(root, ignore_errors=True)
    data = root / "data"
    data.mkdir(parents=True)
    if voc:
        written = write_voc_tree(data, VOC_TRAIN, VOC_VAL)
        extra = [f"data.h5_file={data / 'cluster.h5'}", f"data.lost_file={data / 'lost.h5'}"]
        spe, epochs, val_batches, image_logs = VOC_STEPS, VOC_EPOCHS, VOC_VAL_BATCHES, 1
    else:
        written = write_coco_tree(data, COCO_TRAIN, COCO_VAL)
        extra = [f"data.stego_dir={data / 'stego'}"]
        spe, epochs, val_batches, image_logs = COCO_STEPS, COCO_EPOCHS, COCO_VAL_BATCHES, 0
    vis_every = epochs * spe if image_logs else 10 ** 9
    ends: list = []
    with mock.patch.object(trainer_mod, "init_train_params", init_random_params), \
            mock.patch.object(trainer_mod, "make_train_step", timed_make_train_step(ends)):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tr = main_mod.main([
            "--config", str(here / (VOC_CONFIG if voc else COCO_CONFIG)), "--device", str(dev),
            f"data.root={data}", *extra, f"data.params.batch_size={TRAIN_BATCH}",
            f"pl.trainer.limit_train_batches={spe}", f"pl.trainer.limit_val_batches={val_batches}",
            f"data.vis_every_iter={vis_every}",
            f"model.params.num_timesteps_imagelogger={FIT_IMAGELOG_STEPS}",
            "pl.trainer.log_every_n_steps=2", "data.fid_train_image_dir=null",
            "data.fid_val_image_dir=null", f"data.trainer.max_epochs={epochs - 1}",
            f"log_dir={root / 'run'}"])
        torch.cuda.synchronize()
        fit_seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
    want = seg_fit_launches(epochs * spe, image_logs, epochs * val_batches)
    assert counts == want, f"{run}: launch counts {counts} != {want}"
    spans = step_spans(ends, spe)
    records = fit_records(root / "run", want_images=bool(image_logs))
    assert records["epochs_logged"] == list(range(epochs)), records
    assert tr.state.step == tr.global_step == epochs * spe

    # the reader: the train loader at the config's num_workers, batches 2 and on
    dl = tr.datamodule.train_dataloader()
    first, reader_rate = loader_rate(dl, READER_BATCHES)
    keys = {k: [list(v.shape), str(v.dtype)] for k, v in first.items()}

    # the bare train step on the trainer's model, state and first batches
    bare_spans = bare_steps(tr, dev, spe, epochs)[0]
    del tr

    generate_row = None
    if voc:   # generate --run: boxes drawn at the run's 64 px, cluster ids
        out_dir = root / "samples"
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        generate_mod.main(["--run", str(root / "run"), "--n", str(SEG_GENERATE_N), "--steps",
                           str(FIT_IMAGELOG_STEPS), "--boxes", "8,8,40,40;20,4,60,30;0,32,64,64",
                           "--labels", "3,57,99", "--out", str(out_dir), "--device", str(dev)])
        torch.cuda.synchronize()
        gen_counts = ops.launch_counts()
        gen_want = seg_fit_launches(0, 0, 0)
        gen_want.update({k: FIT_IMAGELOG_STEPS * v for k, v in CA_SAMPLE_LAUNCHES.items()})
        assert gen_counts == gen_want, f"generate --run: launch counts {gen_counts} != {gen_want}"
        pngs = sorted(out_dir.glob("*.png"))
        back = [read_png(p) for p in pngs[:4]]
        assert len(pngs) == SEG_GENERATE_N and all(b.shape == (64, 64, 3) for b in back)
        assert all(b.std() > 0 for b in back), "constant images"
        generate_row = dict(n=SEG_GENERATE_N, steps=FIT_IMAGELOG_STEPS,
                            seconds=time.perf_counter() - t0, launches=gen_counts)
    shutil.rmtree(root, ignore_errors=True)

    s_step, bare_step = sum(spans) / len(spans), sum(bare_spans) / len(bare_spans)
    step_rate = TRAIN_BATCH / s_step
    print(json.dumps({run: dict(
        card=card, batch=TRAIN_BATCH, epochs=epochs, steps_per_epoch=spe, written=written,
        seconds=fit_seconds, s_per_step=s_step, samples_per_s=step_rate,
        s_per_step_by_epoch=spans, bare_s_per_step=bare_step,
        bare_s_per_step_by_round=bare_spans, trainer_over_bare=s_step / bare_step,
        trainer_over_bare_by_epoch=[v / bare_step for v in spans],
        reader_images_per_s=reader_rate, reader_num_workers=dl.num_workers,
        reader_over_step_rate=reader_rate / step_rate, batch_keys=keys,
        launches=counts, records=records, generate_run=generate_row,
        phase_seconds=time.perf_counter() - t_phase)}), flush=True)
    paths = {run: counts}
    if generate_row:
        paths[f"{run}_generate"] = generate_row["launches"]
    return paths


# ---------------------------------------------------------------- phases 8f-8h

def save_dino_state(path, arch: str, seed: int) -> None:
    """A seeded random ViT state dict in torch.hub DINO's format (names and
    layout), as the port's loader and the JAX package's read it."""
    import torch

    from sgdm_tpu_torch.models.vit import vit_base, vit_small
    from sgdm_tpu_torch.selfsup.ssl_backbone import random_vit_state

    with torch.device("meta"):
        model = {"vitb16": lambda: vit_base(16), "vits16": lambda: vit_small(16),
                 "vits8": lambda: vit_small(8)}[arch]()
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(random_vit_state(model, seed), path)


def phase_feat_in64p(dev, card: str) -> tuple[dict, str]:
    """The README's feature extraction on the IN64 tree (module docstring, 8f)."""
    import os
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.data.imagenet_pickle import ImageNetPickle
    from sgdm_tpu_torch.selfsup import feat_extractor
    from sgdm_tpu_torch.selfsup.ssl_backbone import get_ssl_backbone
    from sgdm_tpu_torch.utils import h5

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "feat_in64p"
    shutil.rmtree(root, ignore_errors=True)
    written = write_in64p_tree(root)
    save_dino_state(root / "ckpt" / "dino_vitbase16_pretrain.pth", "vitb16", FEAT_SEED)
    os.environ["SGDM_SSL_CKPT_DIR"] = str(root / "ckpt")
    n_train, n_val = IN64P_TRAIN_FILES * IN64P_PER_FILE, IN64P_VAL

    # (a) the README's command through the CLI, counters 0 before, read after
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    feat_h5 = feat_extractor.main(["--feat", "dino_vitb16", "--ds", "in64p", "--bs",
                                   str(FEAT_BATCH), "--image_size", "64", "--data_root",
                                   str(root / "pack"), "--out_root", str(root / "feat")])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = ops.launch_counts()

    # (b) the file read back
    f = h5.File(feat_h5)
    a = f["all_attributes"].attrs
    attrs = {k: (a[k] if isinstance(a[k], str) else int(a[k])) for k in a}
    assert attrs == dict(dataset_name="in64p", feat_from="dino_vitb16", feat_dim=IN64P_FEAT,
                         version="v4", is_grey=0), attrs
    assert f["train"].shape == (n_train, IN64P_FEAT) and f["val"].shape == (n_val, IN64P_FEAT)
    train_ds = ImageNetPickle(str(root / "pack"), train=True, image_size=64)
    val_ds = ImageNetPickle(str(root / "pack"), train=False, image_size=64)
    assert np.array_equal(f["train_labels"][:], train_ds.label_list)
    assert np.array_equal(f["val_labels"][:], val_ds.label_list)
    feats = f["train"][:]
    assert np.isfinite(feats).all() and np.isfinite(f["val"][:]).all()
    names = json.loads(Path(str(feat_h5).replace(".h5", ".json")).read_text())["name2id"]
    assert len(names) == n_train and names["17.jpg"] == 17   # ids overlap across splits

    # (c) the first rows against the port's CPU forward of the same weights
    imgs = np.stack([train_ds[i]["img4unsup"] for i in range(FEAT_CPU_ROWS)])
    cpu = get_ssl_backbone("dino_vitb16", device="cpu")
    want = cpu.batch_encode_feat(cpu.transform_batch(imgs))
    err = float(np.abs(feats[:FEAT_CPU_ROWS] - want).max())
    del cpu

    # (d) transform + encode alone: a batch of 256 at a time, CUDA events
    bb = get_ssl_backbone("dino_vitb16", device=dev)
    batch = np.stack([train_ds[i]["img4unsup"] for i in range(FEAT_BATCH)])
    encode = lambda: bb.batch_encode_feat(bb.transform_batch(batch), as_numpy=False)
    model_ms = cuda_time(encode, FEAT_TIMED_BATCHES)
    flops = FEAT_BATCH * vit_flops(bb.model, bb.image_size)
    # the same rows with TF32 on: the fault FEAT_TOL must catch
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            tf32 = bb.model(bb.transform_batch(imgs), out="cls").float().cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    tf32_err = float(np.abs(tf32 - want).max())
    del bb

    # (e) --spatial --attn and --tencrop on SyntheticImages' 512 + 128, shapes
    shapes = {}
    for flags in (["--spatial", "--attn"], ["--tencrop"]):
        t0 = time.perf_counter()
        path = feat_extractor.main(["--feat", "dino_vitb16", "--ds", "synthetic", "--bs",
                                    str(FEAT_BATCH), "--image_size", "64", "--out_root",
                                    str(root / "feat_shapes"), *flags])
        g = h5.File(path)
        shapes["_".join(x.strip("-") for x in flags)] = dict(
            {k: list(g[k].shape) for k in g if k != "all_attributes"},
            seconds=time.perf_counter() - t0)
        if flags[0] == "--spatial":
            assert g["train"].shape == (FEAT_SHAPES_N, 197, IN64P_FEAT)
            assert g["train_attentions"].shape == (FEAT_SHAPES_N, FEAT_HEADS, 196)
            assert int(g["all_attributes"].attrs["resampled_size"]) == 14
            cls_to_patches = g["train_attentions"][:8].sum(-1)   # 1 less CLS → CLS
            assert ((cls_to_patches > 0) & (cls_to_patches <= 1 + 1e-5)).all()
        else:
            assert g["train"].shape == (FEAT_SHAPES_N, 10, IN64P_FEAT)
        assert np.isfinite(g["train"][:64]).all()
    del os.environ["SGDM_SSL_CKPT_DIR"]

    row = dict(card=card, images=n_train + n_val, batch=FEAT_BATCH, cli_seconds=cli_s,
               cli_images_per_s=(n_train + n_val) / cli_s, model_ms_per_batch=model_ms,
               model_images_per_s=FEAT_BATCH / model_ms * 1e3,
               model_flops_per_batch=flops, model_bound_ms=flops / F32_FLOP_PER_S * 1e3,
               cpu_rows=FEAT_CPU_ROWS, cpu_max_abs_err=err, cpu_tol=FEAT_TOL,
               tf32_max_abs_err=tf32_err,
               feat_h5_bytes=Path(feat_h5).stat().st_size, tree=written, shapes=shapes,
               launches=counts, phase_seconds=time.perf_counter() - t_phase)
    print(json.dumps({"feat_in64p": row}, default=str), flush=True)
    assert err <= FEAT_TOL < tf32_err, row
    assert not any(counts.values()), counts     # the path has no hand-written kernel
    return {"feat_in64p": counts}, str(feat_h5)


def vit_flops(model, size: int) -> float:
    """Multiply-adds × 2 of one image's ViT forward (patch embedding, qkv,
    attention, projection, MLP)."""
    n = (size // model.patch_size) ** 2 + 1
    d = model.embed_dim
    per_block = 2 * n * d * (3 * d + d + 8 * d) + 2 * 2 * n * n * d
    return model.depth * per_block + 2 * (n - 1) * d * 3 * model.patch_size ** 2


def mixture_features(dev, n: int, seed: int = 0):
    """``n`` seeded rows of KM_MIX Gaussian components in KM_DIM, made on
    the card and copied to the host (float32)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    centres = torch.randn(KM_MIX, KM_DIM, generator=gen, device=dev)
    comp = torch.randint(0, KM_MIX, (n,), generator=gen, device=dev)
    x = centres[comp].add_(torch.randn(n, KM_DIM, generator=gen, device=dev), alpha=KM_NOISE)
    out = x.cpu().numpy()
    del x, centres, comp
    torch.cuda.empty_cache()
    return out


def sq_dists64(x, c, cols: int = 65536):
    """float64 squared distances [len(x), len(c)] on the host, a block of
    ``c``'s rows at a time."""
    import numpy as np

    x = x.astype(np.float64)
    xn = (x * x).sum(1)[:, None]
    out = np.empty((len(x), len(c)))
    for j in range(0, len(c), cols):
        b = c[j:j + cols].astype(np.float64)
        out[:, j:j + cols] = xn + (b * b).sum(1)[None, :] - 2 * x @ b.T
    return out


def phase_cluster_in64p(dev, card: str, feat_h5: str) -> dict:
    """The cluster CLI on the extracted file, then k-means and kNN at IN64
    scale in memory (module docstring, 8g)."""
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.data.h5cond import ConditionLookup
    from sgdm_tpu_torch.device import no_tf32
    from sgdm_tpu_torch.ops.kmeans import run_kmeans
    from sgdm_tpu_torch.ops import knn
    from sgdm_tpu_torch.selfsup import cluster
    from sgdm_tpu_torch.utils import h5

    t_phase = time.perf_counter()
    root = Path(feat_h5).parent.parent / "cluster"
    n_train = IN64P_TRAIN_FILES * IN64P_PER_FILE

    # (a) the README's cluster command on the feat file, read back by the lookup
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = cluster.main(["--feat_h5", feat_h5, "--k", str(IN64P_K), "--niter", str(KM_ITERS),
                        "--nns", "20", "--out_root", str(root)])
    cli_s = time.perf_counter() - t0
    f = h5.File(out)
    assert f["train"].shape == (n_train,) and f["val"].shape == (IN64P_VAL,)
    assert f["centroids"].shape == (IN64P_K, IN64P_FEAT)
    assert f["train_nns"].shape == (n_train, 20) and f["val_nns_radius"].shape == (IN64P_VAL, 20)
    assert f["train_feat"].shape == (n_train, IN64P_FEAT)
    assert 0 <= f["train"][:].min() and f["train"][:].max() < IN64P_K
    assert f["all_attributes"].attrs["dataset_name"] == "in64p"
    lookup = ConditionLookup("cluster", str(out), "train", "in64p", id2name=lambda i: f"{i}.jpg")
    assert lookup.cluster_k == IN64P_K and lookup.get(5)["cluster_id"] == f["train"][5]
    cli = dict(seconds=cli_s, file=Path(out).name, bytes=Path(out).stat().st_size,
               clusters_used=int(len(np.unique(f["train"][:]))))
    shutil.rmtree(Path(feat_h5).parent.parent, ignore_errors=True)

    # (b) run_kmeans at IN64 scale: 1,281,167 + 50,000 rows, d 768, k 5000, KM_ITERS iterations
    t0 = time.perf_counter()
    trainval = mixture_features(dev, KM_TRAIN + KM_VAL)
    train = trainval[:KM_TRAIN].copy()
    make_s = time.perf_counter() - t0
    iters: list[dict] = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, centroids = run_kmeans(train, trainval, KM_K, niter=KM_ITERS, device=dev,
                                   report=iters.append)
    km_s = time.perf_counter() - t0
    del train
    assert "warning" not in iters[0], iters[0]
    obj = [r["objective"] for r in iters]
    secs = [r["seconds"] for r in iters]
    rises = [(i, obj[i + 1] / obj[i] - 1) for i in range(len(obj) - 1)
             if obj[i + 1] > obj[i] * (1 + KM_OBJ_TOL)]
    d64 = sq_dists64(trainval[:KM_CHECK], centroids)
    best2 = np.partition(d64, 1, axis=1)[:, :2]
    gap = (best2[:, 1] - best2[:, 0]) / np.maximum(best2[:, 0], 1e-30)
    wrong = labels[:KM_CHECK] != d64.argmin(1)
    n_sub = min(KM_TRAIN, KM_K * 256)
    flops = 2.0 * n_sub * KM_K * KM_DIM
    iter_s = secs[1:]                  # the first carries the set-up
    km = dict(rows=KM_TRAIN + KM_VAL, trained_rows=n_sub, dim=KM_DIM, k=KM_K, iters=KM_ITERS,
              make_features_s=make_s, seconds=km_s, s_per_iter=secs,
              ms_per_iter_mean=1e3 * sum(iter_s) / len(iter_s),
              bound_ms_per_iter=flops / F32_FLOP_PER_S * 1e3, flops_per_iter=flops,
              objective=obj, objective_rises=rises, split=[r["split"] for r in iters],
              checked=KM_CHECK, mismatched=int(wrong.sum()),
              mismatched_beyond_gap=int((wrong & (gap >= KM_GAP)).sum()), gap=KM_GAP)
    del d64

    # (c) knn_search: 8,192 queries against the 1.33 M rows
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    nd2, nidx = knn.knn_search(trainval, trainval[:KNN_QUERIES], KNN_K, device=dev)
    knn_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    q = trainval[:KNN_CHECK]
    want = sq_dists64(q, trainval)                                   # [64, N]
    got64 = np.take_along_axis(want, nidx[:KNN_CHECK], 1)
    top = np.sort(np.partition(want, KNN_K - 1, axis=1)[:, :KNN_K], axis=1)
    scale = top.max(1, keepdims=True)
    knn_err = float((np.abs(np.sort(got64, 1) - top) / scale).max())
    d2_err = float((np.abs(nd2[:KNN_CHECK] - got64) / scale).max())
    with torch.no_grad(), no_tf32():
        index = torch.as_tensor(trainval).to(dev)
        sqn = (index * index).sum(-1)
        qt = index[:KNN_QUERIES]
        chunk_ms = cuda_time(lambda: knn.search_chunk(qt, index, sqn, KNN_K), 2, warmup=1)
        # the memory one split adds: its products, its topk, and the [rows, N]
        # tie count by `sum` the search no longer makes (a bool mask, then int64)
        rows = knn.MAX_BYTES // (4 * len(index))
        split_bytes = {}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        qr = qt[:rows]
        d2 = (qr * qr).sum(-1, keepdim=True) + sqn[None, :]
        d2.addmm_(qr, index.T, alpha=-2.0).clamp_(min=0.0)
        split_bytes["products"] = torch.cuda.max_memory_allocated(dev) - base
        for name, fn in (("topk", lambda: knn._topk_lowest_index(d2, KNN_K)),
                         ("tie_count_by_sum", lambda: (d2 == d2[:, :1]).sum(1))):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            fn()
            torch.cuda.synchronize()
            split_bytes[name] = torch.cuda.max_memory_allocated(dev) - base
        del index, sqn, qt, qr, d2
    counts = ops.launch_counts()
    n = len(trainval)
    knn_flops = 2.0 * KNN_QUERIES * n * KM_DIM
    knn_bytes = 4.0 * (n * KM_DIM + KNN_QUERIES * KM_DIM) + 12.0 * KNN_QUERIES * KNN_K
    peak_limit = held + 4 * n * KM_DIM + knn.MAX_BYTES + (1 << 30)
    nn_row = dict(index_rows=n, queries=KNN_QUERIES, k=KNN_K, seconds=knn_s, peak_bytes=peak,
                  peak_limit_bytes=peak_limit, split_rows=rows, split_added_bytes=split_bytes,
                  chunk_ms=chunk_ms, chunk_distance_bytes=4.0 * KNN_QUERIES * n,
                  chunk_bound_ms=max(knn_flops / F32_FLOP_PER_S,
                                     knn_bytes / HBM_BYTES_PER_S) * 1e3,
                  chunk_flops=knn_flops, checked=KNN_CHECK, sorted_dist_rel_err=knn_err,
                  d2_rel_err=d2_err, tol=KNN_TOL)
    del trainval, want
    torch.cuda.empty_cache()
    row = dict(card=card, cli=cli, kmeans=km, knn=nn_row, launches=counts,
               phase_seconds=time.perf_counter() - t_phase)
    print(json.dumps({"cluster_in64p": row}, default=float), flush=True)
    assert not rises, rises
    assert km["mismatched_beyond_gap"] == 0, km
    assert knn_err <= KNN_TOL and d2_err <= KNN_TOL, nn_row
    assert peak <= peak_limit, nn_row
    assert not any(counts.values()), counts
    return {"cluster_in64p": counts}


class _Head:
    """The first ``n`` samples of a dataset, with its image names."""

    def __init__(self, ds, n: int):
        self.ds, self.n = ds, n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        return self.ds[i]

    def get_imagename_by_index(self, i: int) -> str:
        return self.ds.get_imagename_by_index(i)


def phase_lost_voc64(dev, card: str) -> dict:
    """The LOST CLI on a written VOC tree (module docstring, 8h)."""
    import importlib
    import os
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.data.h5cond import LostLookup
    from sgdm_tpu_torch.data.voc12 import VOCSegmentation
    from sgdm_tpu_torch.selfsup.ssl_backbone import get_ssl_backbone

    lost = importlib.import_module("sgdm_tpu_torch.selfsup.lost")
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "lost_voc64"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    written = write_voc_tree(root, VOC_TRAIN, VOC_VAL)
    save_dino_state(root / "ckpt" / "dino_deitsmall16_pretrain.pth", "vits16", LOST_SEED)
    os.environ["SGDM_SSL_CKPT_DIR"] = str(root / "ckpt")

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = lost.main(["--ds", "voc64", "--root", str(root), "--cluster_k", str(VOC_K),
                     "--out", str(root / "lost_k100.h5")])
    cli_s = time.perf_counter() - t0
    counts = ops.launch_counts()

    # run_lost against the JAX package's loop of one image at a time, and the
    # reads alone, on the same first images
    card_bb = get_ssl_backbone("dino_vits16", device=dev)
    timed = _Head(VOCSegmentation(str(root), image_size=64), LOST_TIMED)
    fm = card_bb.image_size // card_bb.model.patch_size
    t0 = time.perf_counter()
    for i in range(LOST_TIMED):
        np.asarray(timed[i]["img4unsup"])
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lost.run_lost(card_bb, timed)
    batched_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(LOST_TIMED):
        img = np.asarray(timed[i]["img4unsup"])
        feats = lost.extract_key_features(card_bb, img[None])[0]
        lost.lost(feats, dims=(fm, fm), scales=[card_bb.model.patch_size] * 2,
                  init_image_size=(card_bb.image_size,) * 2)
    one_s = time.perf_counter() - t0
    loop = dict(images=LOST_TIMED, batch=lost.BATCH, read_s=read_s, batched_s=batched_s,
                one_at_a_time_s=one_s, batched_images_per_s=LOST_TIMED / batched_s,
                one_at_a_time_images_per_s=LOST_TIMED / one_s)

    names = [f"2012_{i:06d}.jpg" for i in range(VOC_TRAIN)]
    lk = LostLookup(str(out))
    boxes = np.stack([lk.get_bbox(n) for n in names])
    ids = np.array([lk.get_clusterid(n) for n in names])
    size = 300                                  # img4unsup, the grid the boxes are on
    inside = bool(((boxes[:, :2] >= 0) & (boxes[:, 2:] <= size)
                   & (boxes[:, 2:] > boxes[:, :2])).all())
    assert lk.cluster_k == VOC_K and 0 <= ids.min() and ids.max() < VOC_K

    # the first boxes against the port's CPU run of the same weights and draws
    cpu = get_ssl_backbone("dino_vits16", device="cpu")
    head = _Head(VOCSegmentation(str(root), image_size=64), LOST_BOX_CHECK)
    cpu_names, cpu_boxes, _ = lost.run_lost(cpu, head)
    assert cpu_names == names[:LOST_BOX_CHECK]
    unequal = [i for i in range(LOST_BOX_CHECK) if not np.array_equal(cpu_boxes[i], boxes[i])]
    explained = []
    if unequal:     # a similarity on the other side of 0 changes the degree counts
        imgs = np.stack([head[i]["img4unsup"] for i in range(LOST_BOX_CHECK)])
        kc = lost.extract_key_features(card_bb, imgs)
        kh = lost.extract_key_features(cpu, imgs)
        for i in unequal:
            ac, ah = kc[i] @ kc[i].T, kh[i] @ kh[i].T
            np.fill_diagonal(ac, 0)
            np.fill_diagonal(ah, 0)
            flip = (ac > 0) != (ah > 0)
            explained.append(dict(image=i, degrees_differ=bool(
                ((ac > 0).sum(1) != (ah > 0).sum(1)).any()),
                flipped=int(flip.sum()), max_abs_flipped=float(np.abs(ah[flip]).max())
                if flip.any() else 0.0))
    del os.environ["SGDM_SSL_CKPT_DIR"]
    row = dict(card=card, images=VOC_TRAIN, cli_seconds=cli_s, images_per_s=VOC_TRAIN / cli_s,
               boxes_inside=inside, cluster_ids_used=int(len(np.unique(ids))),
               checked=LOST_BOX_CHECK, unequal_boxes=len(unequal), unequal_explained=explained,
               loop=loop, tree=written, launches=counts, phase_seconds=time.perf_counter() - t_phase)
    print(json.dumps({"lost_voc64": row}, default=str), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    assert inside, row
    assert all(e["degrees_differ"] for e in explained), row
    assert not any(counts.values()), counts
    return {"lost_voc64": counts}


# ---------------------------------------------------------------- phases 8i-8k

def forward_flops(build, shape, **kw) -> float:
    """FLOPs (2 × multiply-adds of the matmuls and convolutions) of one
    forward of ``build()`` on an input of ``shape``, counted on the meta
    device by torch.utils.flop_counter."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = build()
        x = torch.empty(shape)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x, **kw)
    return float(fc.get_total_flops())


def tf32_on(fn):
    """``fn()`` with TF32 matmuls and convolutions on (the fault a tolerance
    must catch)."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def patched(obj, name: str, value):
    """``obj.name`` set to ``value`` inside the block."""
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def phase_stego_coco64(dev, card: str) -> dict:
    """STEGO on a written COCO-Stuff tree (module docstring, 8i)."""
    import os
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.data.cocostuff import CocoStuffDataset
    from sgdm_tpu_torch.models.vit import vit_small
    from sgdm_tpu_torch.native import dense_crf
    from sgdm_tpu_torch.selfsup import stego, stego_train
    from sgdm_tpu_torch.utils.image import read_image
    from sgdm_tpu_torch.utils.png import read_png

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "stego_coco64"
    shutil.rmtree(root, ignore_errors=True)
    (root / "coco").mkdir(parents=True)
    (root / "masks_src").mkdir()
    written = write_coco_tree(root / "coco", COCO_TRAIN, COCO_VAL)
    write_coco_tree(root / "masks_src", 0, STEGO_MASK_IMAGES)  # the CLI's val JPEGs
    save_dino_state(root / "ckpt" / "dino_deitsmall8_pretrain.pth", "vits8", STEGO_SEED)
    os.environ["SGDM_SSL_CKPT_DIR"] = str(root / "ckpt")
    ds = CocoStuffDataset(str(root / "coco"), "train", size4cluster=STEGO_SIZE4CLUSTER)

    # (a) kNN positives and training through train_stego, counters 0 before, read after
    reports = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    st = stego_train.train_stego(ds, arch="vit_small", patch_size=8, dim=STEGO_DIM,
                                 n_classes=COCO_K, steps=STEGO_STEPS, batch_size=STEGO_BATCH,
                                 image_size=224, knn_k=STEGO_KNN, log_every=STEGO_LOG_EVERY,
                                 report=reports.append, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    losses = [r["loss"] for r in reports]
    step_ms = [r["seconds"] / STEGO_LOG_EVERY * 1e3 for r in reports]
    st.save_ckpt(root / "stego.ckpt")

    # (b) the mask CLI on the val JPEGs (640x480 and 480x640) with that checkpoint
    img_dir = root / "masks_src" / "images" / "val2017"
    cli = ["--image_dir", str(img_dir), "--ckpt", str(root / "stego.ckpt"),
           "--n_classes", str(COCO_K), "--dim", str(STEGO_DIM)]
    out, timings = stego.main([*cli, "--out_dir", str(root / "stego")])
    out_raw, _ = stego.main([*cli, "--out_dir", str(root / "stego_raw"), "--no_crf"])
    # the seeded random head (no --ckpt), whose masks hold several ids
    out_seeded, _ = stego.main([*cli[:2], *cli[4:], "--out_dir", str(root / "stego_seeded"),
                                "--no_crf"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()

    # (c) log-probs card against CPU on a whole image and a crop of another,
    # TF32 off and on; the whole image's CLI masks against the CPU's
    card_st = stego.StegoInference(n_classes=COCO_K, dim=STEGO_DIM,
                                   ckpt_path=str(root / "stego.ckpt"), device=dev)
    cpu_st = stego.StegoInference(n_classes=COCO_K, dim=STEGO_DIM,
                                  ckpt_path=str(root / "stego.ckpt"), device="cpu")
    files = stego.image_files(img_dir)[:2]
    imgs = [read_image(files[0]), read_image(files[1])[:STEGO_CPU_CROP[1], :STEGO_CPU_CROP[0]]]
    lp_errs, tf32_err = [], 0.0
    for i, img in enumerate(imgs):
        want, got = cpu_st.log_probs(img), card_st.log_probs(img)
        lp_errs.append(float(np.abs(got - want).max()))
        with patched(stego, "no_tf32", contextlib.nullcontext):   # log_probs turns TF32 off
            tf32 = tf32_on(lambda: card_st.log_probs(img))
        tf32_err = max(tf32_err, float(np.abs(tf32 - want).max()))
        if i == 0:
            cpu_lp, card_lp = want, got
    seeded = [stego.StegoInference(n_classes=COCO_K, dim=STEGO_DIM, device=d).log_probs(imgs[0])
              for d in ("cpu", dev)]
    lp_errs.append(float(np.abs(seeded[1] - seeded[0]).max()))
    lp_err = max(lp_errs)
    assert cpu_lp.shape[1:] == imgs[0].shape[:2]                  # 640x480: no crop, no pad
    cpu_crf = dense_crf(cpu_lp, imgs[0])
    crf_err = float(np.abs(dense_crf(card_lp, imgs[0]) - cpu_crf).max())
    # a pixel whose CPU top-2 gap exceeds twice the card's error cannot flip
    mask_check = {}
    for name, scores, err, d in (("crf", cpu_crf, crf_err, out),
                                 ("no_crf", cpu_lp, lp_errs[0], out_raw),
                                 ("seeded_no_crf", seeded[0], lp_errs[-1], out_seeded)):
        ours = read_png(d / f"{files[0].stem}.png", samples=True)
        top2 = np.sort(scores, axis=0)[-2:]
        ties = (top2[1] - top2[0]) <= 2 * err
        differ = ours != scores.argmax(0)
        mask_check[name] = dict(ids=sorted(int(v) for v in np.unique(ours)), gap=2 * err,
                                near_ties=int(ties.sum()), differ=int(differ.sum()),
                                differ_outside_ties=int((differ & ~ties).sum()),
                                gaps_below={str(t): int((top2[1] - top2[0] < t).sum())
                                            for t in (1e-3, 1e-4, 1e-5, 1e-6)})

    # (d) both mask dirs read back through the COCO-Stuff dataset (data.stego_dir)
    masks = sorted(out.glob("*.png"))
    ids = np.concatenate([read_png(m, samples=True).ravel() for m in masks])
    read_ok, samples = True, []
    for d in (out, out_raw, out_seeded):
        val = CocoStuffDataset(str(root / "masks_src"), "val", stego_dir=str(d), stego_k=COCO_K,
                               condition_method="stegoclusterlayout",
                               size4cluster=STEGO_SIZE4CLUSTER)
        for i in range(len(val)):
            s = val[i]
            in_file = np.unique(read_png(d / f"{Path(val.get_imagename_by_index(i)).stem}.png",
                                         samples=True))
            present = np.flatnonzero(s["stego_attr"])
            read_ok &= bool(
                s["stegomask"].shape == (64, 64, COCO_K)
                and np.array_equal(s["stego_attr"] > 0, s["stegomask"].sum((0, 1)) > 0)
                and len(present) >= 1 and np.isin(present, in_file).all())
            samples.append(s)
    del os.environ["SGDM_SSL_CKPT_DIR"]

    net = [t[0] for t in timings]
    crf = [t[1] for t in timings]
    h, w = read_image(files[0]).shape[:2]
    tokens = (h // 8) * (w // 8)
    flops_224 = forward_flops(lambda: vit_small(8), (1, 3, 224, 224), out="tokens")
    flops_img = forward_flops(lambda: vit_small(8), (1, 3, h, w), out="tokens")
    row = dict(card=card, train_images=len(ds), steps=STEGO_STEPS, batch=STEGO_BATCH,
               train_seconds=train_s, losses=losses, step_ms=step_ms,
               step_ms_after_first=float(np.mean(step_ms[1:])),
               trunk_flops_per_step=2 * STEGO_BATCH * flops_224,
               trunk_bound_ms_per_step=2 * STEGO_BATCH * flops_224 / F32_FLOP_PER_S * 1e3,
               mask_images=len(masks), tokens=tokens, network_ms_per_image=[t * 1e3 for t in net],
               network_flops_per_image=2 * flops_img,
               network_bound_ms=2 * flops_img / F32_FLOP_PER_S * 1e3,
               crf_s_per_image=crf, crf_mean_s=float(np.mean(crf)),
               crf_projected_h_coco_train=float(np.mean(crf)) * COCO_TRAIN2017 / 3600,
               cpu_images=[list(c.shape[:2]) for c in imgs], lp_max_abs_err=lp_err,
               lp_tol=STEGO_LP_TOL, tf32_lp_max_abs_err=tf32_err, crf_max_abs_err=crf_err,
               crf_tol=STEGO_CRF_TOL, mask_ids=sorted(int(i) for i in np.unique(ids)),
               mask_vs_cpu=mask_check, dataset_samples=len(samples),
               dataset_read_ok=read_ok, tree=written, launches=counts,
               phase_seconds=time.perf_counter() - t_phase)
    print(json.dumps({"stego_coco64": row}, default=str), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    assert np.isfinite(losses).all() and len(losses) == STEGO_STEPS // STEGO_LOG_EVERY, row
    assert len(masks) == STEGO_MASK_IMAGES and ids.max() < COCO_K, row
    assert lp_err <= STEGO_LP_TOL < tf32_err and crf_err <= STEGO_CRF_TOL, row
    assert all(m["differ_outside_ties"] == 0
               and m["near_ties"] <= STEGO_TIE_SHARE * cpu_lp[0].size
               for m in mask_check.values()), row
    assert len(mask_check["seeded_no_crf"]["ids"]) > 1, row          # the check can bite
    assert read_ok and len(samples) == 3 * STEGO_MASK_IMAGES, row
    assert not any(counts.values()), counts     # the path has no hand-written kernel
    return {"stego_coco64": counts}


def backbone_file(path, name: str, seed: int) -> None:
    """A seeded random checkpoint of backbone ``name`` in its loader's format
    (the published files' layouts: torchvision, pl_bolts SimCLR, VISSL
    consolidated, SwAV, facebookresearch XCiT), at full width."""
    import torch

    from sgdm_tpu_torch.models.resnet import ResNet50, resnet101
    from sgdm_tpu_torch.models.xcit import xcit_medium_24_p8

    model = {"vissl_simclr": resnet101, "dino_xcit_m24_p8": xcit_medium_24_p8}.get(name, ResNet50)()
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        elif k.endswith("running_mean") or k.endswith("bias"):
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
        elif v.ndim >= 2 and k != "cls_token":
            sd[k] = torch.randn(v.shape, generator=g) / float(math.sqrt(v[0].numel()))
        else:
            sd[k] = v.clone()                     # BN / LN scales, η, temperatures, counters
    if name == "rn50":
        obj = {**sd, "fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000)}
    elif name == "simclr_rn50":
        obj = {"state_dict": {f"encoder.{k}": v for k, v in sd.items()}}
    elif name in ("vissl_simclr", "vissl_jigsaw"):
        obj = {"classy_state_dict": {"base_model": {"model": {
            "trunk": {f"_feature_blocks.{k}": v for k, v in sd.items()}}}}}
    elif name == "vissl_deepclusterv2":
        obj = {f"module.{k}": v for k, v in sd.items()}
    else:
        obj = sd
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(obj, path)


def phase_backbones(dev, card: str) -> dict:
    """Every non-ViT backbone name at full width (module docstring, 8j)."""
    import os
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.selfsup import ssl_backbone

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "backbones"
    shutil.rmtree(root, ignore_errors=True)
    os.environ["SGDM_SSL_CKPT_DIR"] = str(root)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (BACKBONE_BATCH, 224, 224, 3), dtype=np.uint8)
    rows, counts = {}, {}
    for i, name in enumerate(BACKBONES):
        backbone_file(root / ssl_backbone._CKPT_NAMES[name], name, 100 + i)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        bb = ssl_backbone.get_ssl_backbone(name, device=dev)
        encode = lambda: bb.batch_encode_feat(bb.transform_batch(imgs), as_numpy=False)  # noqa
        feats = encode().cpu().numpy()
        ms = cuda_time(encode, BACKBONE_TIMED, warmup=1)
        torch.cuda.synchronize()
        counts[name] = ops.launch_counts()
        n_cpu = BACKBONE_CPU_ROWS[name]
        cpu = ssl_backbone.get_ssl_backbone(name, device="cpu")
        want = cpu.batch_encode_feat(cpu.transform_batch(imgs[:n_cpu]))
        scale = max(1.0, float(np.abs(want).max()))
        err = float(np.abs(feats[:n_cpu] - want).max()) / scale
        with torch.no_grad():      # the model alone: `encode` turns TF32 off
            tf32 = tf32_on(lambda: bb.model(bb.transform_batch(imgs[:n_cpu])).float())
        tf32_err = float(np.abs(tf32.cpu().numpy() - want).max()) / scale
        flops = forward_flops(ssl_backbone._OTHERS[name][0], (1, 3, 224, 224))
        rows[name] = dict(feat_dim=bb.feat_dim, feats_shape=list(feats.shape),
                          finite=bool(np.isfinite(feats).all()), ms_per_batch=ms,
                          images_per_s=BACKBONE_BATCH / ms * 1e3,
                          flops_per_batch=BACKBONE_BATCH * flops,
                          bound_ms=BACKBONE_BATCH * flops / F32_FLOP_PER_S * 1e3,
                          cpu_rows=n_cpu, cpu_rel_err=err, tol=BACKBONE_TOL,
                          tf32_rel_err=tf32_err, launches=counts[name])
        del bb, cpu
        (root / ssl_backbone._CKPT_NAMES[name]).unlink()
    del os.environ["SGDM_SSL_CKPT_DIR"]
    row = dict(card=card, batch=BACKBONE_BATCH, image_size=224, backbones=rows,
               phase_seconds=time.perf_counter() - t_phase)
    print(json.dumps({"backbones": row}, default=str), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    for name, r in rows.items():
        assert r["finite"] and r["feats_shape"] == [BACKBONE_BATCH, r["feat_dim"]], (name, r)
        assert r["cpu_rel_err"] <= BACKBONE_TOL < r["tf32_rel_err"], (name, r)
        assert not any(r["launches"].values()), (name, r)
    return {"backbones": add_counts(*counts.values())}


def phase_cluster_pca_in64p(dev, card: str, feat_h5: str) -> dict:
    """PCA-view and ensemble clustering of 8f's file (module docstring, 8k)."""
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.selfsup import cluster_pca
    from sgdm_tpu_torch.utils import h5

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "cluster_pca_in64p"
    shutil.rmtree(root, ignore_errors=True)
    runs, counts = {}, {}
    for kind in ("pca", "ensemble"):
        reports = []
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if kind == "pca":
            out = cluster_pca.clustering_pca(feat_h5, cluster_k=PCA_K, niter=PCA_NITER,
                                             pca_group=PCA_VIEWS, cluster_h5_root=str(root),
                                             report=reports.append, device=dev)
        else:
            out = cluster_pca.clustering_ensemble(feat_h5, cluster_k=PCA_K, niter=PCA_NITER,
                                                  ensemble_num=PCA_VIEWS,
                                                  cluster_h5_root=str(root),
                                                  report=reports.append, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts[kind] = ops.launch_counts()
        f = h5.File(out)
        train, val = f["train"][:], f["val"][:]
        a = f["all_attributes"].attrs
        feat = h5.File(feat_h5)
        n_train, n_val = feat["train"].shape[0], feat["val"].shape[0]
        runs[kind] = dict(file=out.name, seconds=seconds, reports=reports,
                          train_shape=list(train.shape), val_shape=list(val.shape),
                          dtype=str(train.dtype),
                          in_range=bool(((train >= 0) & (train < PCA_K)).all()
                                        and ((val >= 0) & (val < PCA_K)).all()),
                          clusters_used=[int(len(np.unique(train[:, v])))
                                         for v in range(PCA_VIEWS)],
                          cluster_k=int(a["cluster_k"]), feat_dim=int(a["feat_dim"]),
                          expected=[[n_train, PCA_VIEWS], [n_val, PCA_VIEWS]],
                          launches=counts[kind])
    row = dict(card=card, k=PCA_K, niter=PCA_NITER, views=PCA_VIEWS, runs=runs,
               phase_seconds=time.perf_counter() - t_phase)
    print(json.dumps({"cluster_pca_in64p": row}, default=str), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    for kind, r in runs.items():
        assert [r["train_shape"], r["val_shape"]] == r["expected"], (kind, r)
        assert r["dtype"] == "int64" and r["in_range"] and r["cluster_k"] == PCA_K, (kind, r)
        assert not any(r["launches"].values()), (kind, r)
    return {"cluster_pca_in64p": add_counts(*counts.values())}


# ---------------------------------------------------------------- phase 9

def add_counts(*counts: dict) -> dict:
    return {k: sum(c.get(k, 0) for c in counts) for k in META}


def rel_errs(got: dict, ref: dict) -> dict:
    return {k: float((got[k].float().cpu() - ref[k]).abs().max() / ref[k].abs().max())
            for k in ("pool3", "logits", "spatial")}


def phase_fid(dev, card: str) -> tuple[dict, dict]:
    """The FID path at full width (the FID InceptionV3 at 299, 23,850,960
    parameters, the port's random network; IN64 unet_fast): the extractor's
    resizes and outputs on the card against the CPU; its images/s, PNG
    decode ms an image, seconds per sqrtm and per get_fid_dict; the CLI with
    validation FID (FIT_CONFIG, best checkpoint) and its test phase
    restored from ckpts/last; `fid_cli` on two of the dirs, a subprocess
    left running (the second value; `fid_cli_finish` reads it).  Launch
    counts exact (per sampling forward K1 17, K2 4, K3 6)."""
    import shutil
    from pathlib import Path
    from unittest import mock

    import numpy as np
    import scipy.linalg
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.data.synthetic import SyntheticImages
    from sgdm_tpu_torch.eval import harness
    from sgdm_tpu_torch.eval.fid_engine import InceptionExtractor, resize_299
    from sgdm_tpu_torch.eval.inception import build_inception, random_params
    from sgdm_tpu_torch.models.factory import init_random_params
    from sgdm_tpu_torch.training import trainer as trainer_mod
    from sgdm_tpu_torch.utils.png import read_png, write_png

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "fid"
    shutil.rmtree(root, ignore_errors=True)

    # (a) the extractor's pieces on the card against the CPU
    imgs = np.random.default_rng(0).integers(0, 256, (FID_IMAGES, 64, 64, 3), dtype=np.uint8)
    host = torch.from_numpy(imgs)
    state = random_params(0)
    cpu_net, card_net = build_inception(state, "cpu"), build_inception(state, dev)
    resize_err, out_err, tf32_err = {}, {}, {}
    for mode in ("clean", "bilinear"):
        x_cpu = resize_299(host, mode)
        resize_err[mode] = float((resize_299(host.to(dev), mode).cpu() - x_cpu).abs().max()) * 127.5
        with torch.inference_mode():
            ref = cpu_net(x_cpu)
            with full_f32():
                out_err[mode] = rel_errs(card_net(x_cpu.to(dev)), ref)
            tf32_err[mode] = rel_errs(card_net(x_cpu.to(dev)), ref)   # cuDNN's default TF32
    del cpu_net, card_net

    # (b) extractor images/s (upload, resize, network, features to the host)
    ex = InceptionExtractor(device=dev, batch_size=FID_BATCH)
    batch = np.random.default_rng(1).integers(0, 256, (4 * FID_BATCH, 64, 64, 3), dtype=np.uint8)
    images_per_s = {}
    for mode in ("clean", "bilinear"):
        ex.features_from_arrays(batch[:FID_BATCH], mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = ex.features_from_arrays(batch, mode)
        torch.cuda.synchronize()
        images_per_s[mode] = len(batch) / (time.perf_counter() - t0)
        assert all(np.isfinite(v).all() for v in feats.values())
    print(json.dumps({"fid_extractor": dict(
        card=card, images=FID_IMAGES, resize_max_abs_err_0_255=resize_err,
        rel_err_full_f32=out_err, rel_err_tf32=tf32_err, resize_tol=RESIZE_TOL,
        inception_tol=INCEPTION_TOL, batch=FID_BATCH, images_per_s=images_per_s)}), flush=True)
    assert all(v <= RESIZE_TOL for v in resize_err.values()), resize_err
    assert all(v <= INCEPTION_TOL for e in out_err.values() for v in e.values()), out_err

    # PNG decode, ms an image: 64 images under each row filter (our writer),
    # then the reference dir
    decode_ms = {}
    for kind in range(5):
        d = root / f"png_filter{kind}"
        d.mkdir(parents=True)
        for i, img in enumerate(batch[:64]):
            write_png(d / f"img{i}.png", img, filter_type=kind)
        for _ in range(2):  # the second pass: files in the page cache, code warm
            t0 = time.perf_counter()
            back = [read_png(d / f"img{i}.png") for i in range(64)]
            decode_ms[kind] = (time.perf_counter() - t0) * 1e3 / len(back)
        assert all(np.array_equal(a, b) for a, b in zip(back, batch[:64])), kind
    data = SyntheticImages(size=64, num_classes=1000, length=FID_REF_N, seed=3, cond_key="cluster")
    ref_dir = harness.generate_fid_reference_dir(data, root / "ref", FID_REF_N)
    t0 = time.perf_counter()
    n_ref = len([read_png(p) for p in ref_dir.iterdir()])
    decode_ms["ref_dir"] = (time.perf_counter() - t0) * 1e3 / n_ref

    # (c) the CLI with validation FID, then its test phase; every FID call,
    # sample dir and sqrtm timed where the harness makes it
    calls: dict = {"sqrtm_s": [], "fid_dict": [], "sample_dir": []}
    real_sqrtm, real_fid, real_s2d = scipy.linalg.sqrtm, harness.get_fid_dict, harness.sample_to_dir

    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if name == "sqrtm_s":
                calls[name].append(dt)
            else:
                calls[name].append(dict(dir=Path(a[0] if name == "fid_dict" else a[3]).name,
                                        seconds=dt, **({"debug": k.get("debug")}
                                                       if name == "fid_dict" else {})))
            return out
        return call

    run = root / "run"
    data_ovs = [f"data.fid_train_image_dir={ref_dir}", f"data.val_fid_num={FID_VAL_NUM}",
                "data.fid_every_n_epoch=1", "data.vis_every_iter=1000000000",
                f"data.test_fid_num={FID_TEST_NUM}",
                f"model.params.num_timesteps_val={FID_VAL_STEPS}",
                f"model.params.num_timesteps_test={FID_TEST_STEPS}"]
    spe = FIT_STEPS_PER_EPOCH
    with mock.patch.object(trainer_mod, "init_train_params", init_random_params), \
            mock.patch.object(scipy.linalg, "sqrtm", timed("sqrtm_s", real_sqrtm)), \
            mock.patch.object(harness, "get_fid_dict", timed("fid_dict", real_fid)), \
            mock.patch.object(harness, "sample_to_dir", timed("sample_dir", real_s2d)):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        # no test modes here; the validation FIDs in the trainer's debug mode
        # (clean FID, sFID, PRDC: no fid_tf), the test phase's in full
        fit_cli(dev, run, FID_EPOCHS, *data_ovs, "exp.cond_scale=false", "sg.params.debug=true")
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_counts = ops.launch_counts()
        # per epoch: the val loss (params, EMA) of FIT_VAL_BATCHES batches, then
        # FID samples in train-loader batches of TRAIN_BATCH, FID_VAL_STEPS
        # forwards each (the CFG pair is one forward)
        fid_batches = [math.ceil(max(int(FID_VAL_NUM * (0.1 if e == 0 else 1.0)), 16)
                                 / TRAIN_BATCH) for e in range(FID_EPOCHS)]
        want = add_counts(fit_launches(FID_EPOCHS * spe, 0, FID_EPOCHS * FIT_VAL_BATCHES),
                          sampling_launches(sum(fid_batches) * FID_VAL_STEPS))
        assert fit_counts == want, f"fid_fit: launch counts {fit_counts} != {want}"
        n_fit_calls = {k: len(v) for k, v in calls.items()}
        figure_s: dict = {}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        # one cond scale, 0 (the list is [s, 0] and the validation FID sampled
        # at s = 2): a depth cut of the test phase's loop over scales; the
        # IN64 paper figures ride it (the in-loop grids the primary run's
        # first batches, the chain and the sweep their own sampler calls)
        with timed_figures(figure_s):
            fit_cli(dev, run, FID_EPOCHS, *data_ovs, "train=false", "exp.test_oracle=false",
                    "sg.params.cond_scale=0", f"resume_from={run / 'ckpts' / 'last'}",
                    *(f"vis.{k}=true" for k in VIS_IN64))
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        test_counts = ops.launch_counts()
        # the FID batches, then the pred_x0 chain (one batch of the chain's 7
        # samples at scale 0) and the guidance sweep (5 weights, one doubled
        # batch), FID_TEST_STEPS forwards each
        want = sampling_launches((math.ceil(FID_TEST_NUM / TRAIN_BATCH) + 2) * FID_TEST_STEPS)
        assert test_counts == want, f"fid_test: launch counts {test_counts} != {want}"
    vis_in64_check(run / "papervis", figure_s, card)
    vis_points_timing(dev, ref_dir, card)

    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    oracle = [r["val/oracle_fid"] for r in recs if "val/oracle_fid" in r]
    for_ckpt = [(r["epoch"], r["val/fid_for_ckpt"]) for r in recs if "val/fid_for_ckpt" in r]
    meta = json.loads((run / "ckpts" / "meta.json").read_text())
    results = json.loads((run / "test_results.json").read_text())
    tags = sorted({k.split("/")[1] for k in results if k.startswith("test/")})
    n_val = len(list((run / f"val_samples_ep{FID_EPOCHS - 1}_rank0").glob("img*.png")))
    val_last = [c for c in calls["fid_dict"] + calls["sample_dir"]
                if c["dir"] == f"val_samples_ep{FID_EPOCHS - 1}_rank0"]
    print(json.dumps({"fid_cli_run": dict(
        card=card, epochs=FID_EPOCHS, steps_per_epoch=spe, ref_images=FID_REF_N,
        val_fid_num=FID_VAL_NUM, val_steps=FID_VAL_STEPS, test_fid_num=FID_TEST_NUM,
        test_steps=FID_TEST_STEPS, fit_seconds=fit_s, test_phase_seconds=test_s,
        oracle_fid=oracle, fid_for_ckpt=for_ckpt, best=meta.get("best_path"),
        best_score=meta.get("best_score"), test_tags=tags, test_results=results,
        val_fid_seconds_per_256=sum(c["seconds"] for c in val_last) * 256 / n_val,
        fid_dict_calls=calls["fid_dict"], sample_dir_calls=calls["sample_dir"],
        sqrtm_s=calls["sqrtm_s"], calls_in_fit=n_fit_calls, launches_fit=fit_counts,
        launches_test=test_counts, decode_ms_per_image=decode_ms)}), flush=True)
    assert len(oracle) == 1 and all(math.isfinite(v) for v in oracle), oracle
    assert [e for e, _ in for_ckpt] == list(range(FID_EPOCHS)), for_ckpt
    assert all(math.isfinite(v) for _, v in for_ckpt), for_ckpt
    assert meta["best_score"] == min(v for _, v in for_ckpt) and Path(meta["best_path"]).is_dir()
    assert n_val == int(FID_VAL_NUM * 0.1), n_val
    assert tags == [f"ddim{FID_TEST_STEPS}_s0"], tags
    assert all(math.isfinite(v) for v in results.values()), results
    assert len([k for k in results if k.startswith(f"test/{tags[0]}/")]) == 11, results
    assert {k for k in results if not k.startswith("test/")} == {"knn_mean_nn_dist",
                                                                  "knn_mean_k_dist"}, results

    # (d) `python -m sgdm_tpu_torch.eval.fid_cli` on the reference dir and
    # the last validation samples (--debug: clean FID, sFID, PRDC; a fresh
    # process, so the reference dir is read and featurised again), started
    # now and read by `fid_cli_finish`: its time is the host's sqrtm, which
    # runs slower beside the test phase's own
    harness._EXTRACTORS.clear()
    cli = start_cli([str(ref_dir), str(run / f"val_samples_ep{FID_EPOCHS - 1}_rank0"),
                     "--debug", "--device", str(dev)], root / "fid_cli.log",
                    module="sgdm_tpu_torch.eval.fid_cli", out=root / "fid_cli.json")
    return {"fid_fit": fit_counts, "fid_test": test_counts}, dict(
        root=root, proc=cli, card=card, t_phase=t_phase)



# the papervis / kNN / t-SNE entry points a figure's seconds are read from
FIGURE_FNS = {"sgdm_tpu_torch.eval.papervis": (
    "draw_grid_img", "draw_grid_clustervis", "draw_grid_interp", "draw_chain_grid",
    "draw_grid_stego_chainvis", "draw_grid_lost_chainvis", "draw_grid_random_stego_with_mask",
    "draw_grid_random_lost_with_box", "draw_grid", "cluster_hist_vis_fn",
    "condscale_sweep_images"),
    "sgdm_tpu_torch.eval.knn_eval": ("get_knn_eval_dict",),
    "sgdm_tpu_torch.eval.tsne": ("kluster_tsne_vis",)}


@contextlib.contextmanager
def timed_figures(store: dict):
    """Each figure function's seconds summed into ``store`` by name (the
    harness looks them up on their modules at call time)."""
    import importlib

    import torch

    saved = []

    def wrap(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            store[name] = store.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    for mod_name, names in FIGURE_FNS.items():
        mod = importlib.import_module(mod_name)
        for n in names:
            saved.append((mod, n, getattr(mod, n)))
            setattr(mod, n, wrap(n, getattr(mod, n)))
    try:
        yield store
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def png_shapes(folder) -> dict:
    from sgdm_tpu_torch.utils.png import read_png

    return {p.name: list(read_png(p).shape) for p in sorted(folder.glob("*.png"))}


def vis_in64_check(papervis, figure_s: dict, card: str) -> None:
    """The IN64 figures of the fid phase's test call: every file, its shape."""
    shapes = png_shapes(papervis)
    g = lambda n, ncol, px=64, pad=2: [-(-n // ncol) * (px + pad) - pad, ncol * (px + pad) - pad, 3]
    want = {"cluster_random_uncurated_0.png": g(81, 9),
            "cluster_samecondition_0.png": g(FID_TEST_NUM, 9),
            "cluster_interp_0.png": g(FID_TEST_NUM, 9),
            "condscale_sweep.png": g(5, 5), "cluster_hist_vis.png": [400, 800, 3],
            "tsne.png": [600, 600, 3], "knn_grid.png": g(60, 6)}
    print(json.dumps({"vis_in64": dict(card=card, figures=shapes, figure_seconds=figure_s)}),
          flush=True)
    for name, shape in want.items():
        assert shapes.get(name) == shape, (name, shapes.get(name), shape)
    chain = shapes["chainvis.png"]
    assert chain[0] == g(7, 1)[0] and (chain[1] + 2) % 66 == 0, chain   # 7 rows of 64-px slots
    assert [n for n in shapes if n.startswith("cluster") and n[7:-4].isdigit()], shapes


def vis_points_timing(dev, ref_dir, card: str) -> None:
    """kNN and t-SNE on 2 × VIS_POINTS points, seconds each: VIS_POINTS
    reference images embedded once by the SimCLR ResNet-50 (seeded
    weights), the search of those features among themselves, and the exact
    t-SNE of them beside a jittered copy."""
    import numpy as np
    import torch

    from sgdm_tpu_torch.eval import knn_eval, tsne
    from sgdm_tpu_torch.ops.knn import knn_search
    from sgdm_tpu_torch.selfsup.ssl_backbone import get_ssl_backbone

    bb = get_ssl_backbone("simclr_rn50", device=dev)
    t0 = time.perf_counter()
    feats, _ = knn_eval.embed_image_dir(ref_dir, bb, max_items=VIS_POINTS)
    embed_s = time.perf_counter() - t0
    both = np.concatenate([feats, feats + 1e-3 * np.random.default_rng(0).standard_normal(
        feats.shape).astype(np.float32)])
    t0 = time.perf_counter()
    d2, _ = knn_search(both, both, 5, device=dev)
    knn_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xy, kl = tsne.tsne_embed(both, 30.0, device=dev)
    tsne_s = time.perf_counter() - t0
    print(json.dumps({"vis_points": dict(card=card, points=len(both), embed_s=embed_s,
                                         knn_search_s=knn_s, tsne_embed_s=tsne_s,
                                         tsne_kl=kl)}), flush=True)
    assert np.isfinite(xy).all() and math.isfinite(kl) and np.isfinite(d2).all()


def fid_cli_finish(cli: dict) -> None:
    """Phase fid's last step: waits for the fid_cli run `phase_fid` started
    (run beside phase parallel when both are asked for), checks its JSON and
    removes the phase's tree."""
    import shutil

    rc, err, cli_s = finish_cli(cli["proc"], PAR_RANK_TIMEOUT)
    assert rc == 0, err[-4000:]
    cli_out = json.loads((cli["root"] / "fid_cli.json").read_text())
    shutil.rmtree(cli["root"], ignore_errors=True)
    print(json.dumps({"fid_cli": dict(card=cli["card"], debug=True, seconds=cli_s,
                                      result=cli_out)}), flush=True)
    assert set(cli_out) == {"fid", "clean_fid_raw", "sfid", "precision", "recall", "density",
                            "coverage"}, cli_out
    assert all(math.isfinite(v) for v in cli_out.values()), cli_out
    print(json.dumps({"fid_phase": dict(card=cli["card"],
                                        seconds=time.perf_counter() - cli["t_phase"])}),
          flush=True)


# ---------------------------------------------------------------- phase 10

def par_world(cards: int) -> tuple[int, str]:
    """Ranks and backend of the multi-rank checks: min(cards, PAR_WORLD_MAX)
    over NCCL with two cards or more, else two ranks sharing the card over
    gloo (NCCL refuses two ranks on one device)."""
    return (min(cards, PAR_WORLD_MAX), "nccl") if cards >= 2 else (2, "gloo")


def par_steps(step, state, batches, steps: int, *, local=None, grads_at: int | None = 0):
    """``steps`` train steps on ``batches`` in turn (``local``: this rank's
    rows of each), seed 0; returns (state, losses, the gradient of step
    ``grads_at``, ms a step after the first)."""
    import torch

    losses, grads, t0 = [], None, None
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        b = batches[i % len(batches)]
        b = b if local is None else {k: v[local] for k, v in b.items()}
        state, met = step(state, b, seed=0, return_grads=i == grads_at)
        losses.append(met["loss"].item())
        if i == grads_at:
            grads = met["grads"].double()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (steps - 1) if steps > 1 else None
    return state, losses, grads, ms


def par_tp_model(dev):
    """build_train's IN64 run at PAR_TP_BATCH with einsum attention, as
    tensor parallelism runs it (a ResBlock holding a shard takes its
    composition; `composition_route` puts a whole model's there)."""
    from sgdm_tpu_torch.models.layers import set_routes

    run = build_train(dev)
    set_routes(run["model"], flash=False)
    run["batches"] = [{k: v[:PAR_TP_BATCH] for k, v in b.items()} for b in run["batches"]]
    return run


def composition_route():
    """Every ResBlock takes its unfused composition (the plain conv route
    that a tensor-parallel shard takes) while this context is open."""
    from unittest import mock

    from sgdm_tpu_torch.models.layers import ResBlock

    return mock.patch.object(ResBlock, "fused_route", lambda self, x, train: False)


def par_diff(loss: float, grads, ref_loss: float, ref_grads) -> dict:
    """A run's first loss and gradient against world 1's: the loss's
    relative difference, the gradients' cosine and their largest difference
    over the largest reference element."""
    return dict(loss_rel_diff=abs(loss - ref_loss) / abs(ref_loss),
                grad_cosine=(grads @ ref_grads / (grads.norm() * ref_grads.norm())).item(),
                grad_max_rel_err=((grads - ref_grads).abs().max()
                                  / ref_grads.abs().max()).item())


def par_within(d: dict, grad_rel: float = PAR_GRAD_REL) -> bool:
    """Whether a `par_diff` reading meets the multi-rank limits."""
    return (d["loss_rel_diff"] <= PAR_LOSS_TOL and d["grad_cosine"] >= PAR_GRAD_COS
            and d["grad_max_rel_err"] <= grad_rel)


def start_cli(argv: list[str], log, module: str = "sgdm_tpu_torch.main",
              out=None) -> subprocess.Popen:
    """``python -m module argv`` started in its own process group (so
    `stop_cli` reaches every rank it starts), its standard error written to
    the file ``log`` and its standard output to ``out`` (None: dropped);
    stopped at this script's exit if still running."""
    import atexit
    import os
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    with open(log, "w") as err, open(out or os.devnull, "w") as std:
        proc = subprocess.Popen([sys.executable, "-m", module, *argv], cwd=root,
                                env=env, stdout=std, stderr=err, start_new_session=True)
    proc.log, proc.t0 = log, time.perf_counter()
    atexit.register(stop_cli, proc)
    return proc


def stop_cli(proc: subprocess.Popen) -> None:
    """Kills a `start_cli` process group that is still running."""
    import os
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def finish_cli(proc: subprocess.Popen, timeout: float) -> tuple[int, str, float]:
    """Waits for a `start_cli` run until ``timeout`` seconds after its start
    (past it the group is stopped and TimeoutExpired raised); returns (exit
    code, standard error, seconds from start to exit)."""
    from pathlib import Path

    try:
        proc.wait(timeout=max(0.0, proc.t0 + timeout - time.perf_counter()))
    except subprocess.TimeoutExpired:
        stop_cli(proc)
        raise
    return proc.returncode, Path(proc.log).read_text(), time.perf_counter() - proc.t0


def parallel_rank(rank: int, world: int, backend: str, store: str, ref_path: str) -> dict:
    """One rank of phase parallel's multi-rank checks (see `phase_parallel`)."""
    from unittest import mock

    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.models.layers import ResBlock, set_routes
    from sgdm_tpu_torch.parallel import mesh as pm
    from sgdm_tpu_torch.parallel.fsdp import StateSharding, shard_train_state, state_bytes
    from sgdm_tpu_torch.parallel.tp import shard_model
    from sgdm_tpu_torch.training import state as state_mod
    from sgdm_tpu_torch.training.state import create_train_state, make_train_step

    cards = torch.cuda.device_count()
    dev = torch.device("cuda", rank % cards)
    pm.init_process_group(dev, rank=rank, world_size=world, init_method=f"file://{store}",
                          backend=backend)
    ref = torch.load(ref_path, map_location=dev, weights_only=True)
    out: dict = {"rank": rank, "device": str(dev), "backend": backend}
    try:
        # DDP: PAR_STEPS steps at the global batch, against world 1
        mesh = pm.create_mesh(("data",))
        run = build_train(dev)
        model, tx, diffusion = run["model"], run["tx"], run["diffusion"]
        ddp = make_train_step(model, diffusion, tx, cond_drop_prob=0.1, ema_decay=0.9999,
                              fused_optim=True, device=dev, mesh=mesh)
        local = pm.local_batch_slice(TRAIN_BATCH)
        start = run["state"].clone()
        ops.reset_launch_counts()
        state, losses, grads, ms = par_steps(ddp, run["state"], run["batches"], PAR_STEPS,
                                             local=local)
        counts = ops.launch_counts()
        same = pm.broadcast(state.params.clone(), src=0)  # rank 0's parameters
        g1 = ref["grads"]
        # controls: each rank's dropout masks from row 0 (the offset left
        # out), and the gradient an all-reduce that sums would give
        real_loss = state_mod._loss

        def offset0(*a, dropout_rows, **kw):
            return real_loss(*a, dropout_rows=(0, dropout_rows[1]), **kw)

        with mock.patch.object(state_mod, "_loss", offset0):
            _, met = ddp(start, {k: v[local] for k, v in run["batches"][0].items()}, seed=0,
                         return_grads=True)
        controls = dict(
            dropout_offset_0=par_diff(met["loss"].item(), met["grads"].double(),
                                      ref["losses"][0], g1),
            summed_gradient=par_diff(losses[0], grads * world, ref["losses"][0], g1))
        del start, met
        # DDP's collective alone: the flat f32 gradient's all-reduce over NCCL
        buf = torch.ones(N_PARAMS_IN64, dtype=torch.float32, device=dev)
        allreduce_ms = (cuda_time(lambda: pm.all_reduce(buf, mesh.group("data")),
                                  PAR_ALLREDUCE_ITERS) if backend == "nccl" else None)
        del buf
        out["ddp"] = dict(
            par_diff(losses[0], grads, ref["losses"][0], g1),
            losses=losses, ms_per_step=ms, launches=counts, nccl_allreduce_ms=allreduce_ms,
            loss_rel_diff=max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
            param_max_abs_diff=(state.params - ref["params"]).abs().max().item(),
            params_equal_rank0=bool(torch.equal(state.params, same)), controls=controls)
        del state, run, ddp, grads, same
        torch.cuda.empty_cache()

        # FSDP: its per-rank state bytes, PAR_FSDP_STEPS steps on its route
        run = build_train(dev)
        set_routes(run["model"], flash=False)
        whole = state_bytes(run["state"])
        state = shard_train_state(run["state"], mesh)
        fsdp = make_train_step(run["model"], run["diffusion"], run["tx"], cond_drop_prob=0.1,
                               ema_decay=0.9999, fused_optim=True, device=dev, mesh=mesh)
        ops.reset_launch_counts()
        state, losses, _, ms = par_steps(fsdp, state, run["batches"], PAR_FSDP_STEPS,
                                         local=local, grads_at=None)
        out["fsdp"] = dict(losses=losses, ms_per_step=ms, launches=ops.launch_counts(),
                           bytes_per_rank=state_bytes(state), bytes_one_rank=whole,
                           loss_rel_diff=max(abs(a - b) / abs(b) for a, b in
                                             zip(losses, ref["fsdp_losses"])))
        del state, run, fsdp
        torch.cuda.empty_cache()

        # TP on ('data', 'model') = (world / 2, 2), the plain route, one step
        tp_mesh = pm.create_mesh(("data", "model"), (world // 2, 2))
        run = par_tp_model(dev)
        plan = shard_model(run["model"], tp_mesh)
        st = create_train_state(run["model"], run["tx"], device=dev)
        st.sharding = StateSharding(tp=plan)
        st.step = st.ema_updates = st.opt_state.count = st.opt_state.schedule_count = \
            TRAIN_COUNT
        tp = make_train_step(run["model"], run["diffusion"], run["tx"], cond_drop_prob=0.1,
                             ema_decay=0.9999, fused_optim=True, device=dev, mesh=tp_mesh)
        tp_batch = {k: v[pm.local_batch_slice(PAR_TP_BATCH)] for k, v in
                    run["batches"][0].items()}
        start = st.clone()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        st, met = tp(st, tp_batch, seed=0, return_grads=True)
        torch.cuda.synchronize()
        tp_s = time.perf_counter() - t0
        tp_counts = ops.launch_counts()
        loss = met["loss"].item()
        reading = par_diff(loss, plan.gather_flat(met["grads"]).double(), ref["tp_loss"],
                           ref["tp_grads"])
        # control: the same step with the ResBlocks' dropout left out
        for m in run["model"].modules():
            if isinstance(m, ResBlock):
                m.dropout = 0.0
        _, met = tp(start, tp_batch, seed=0, return_grads=True)
        no_dropout = par_diff(met["loss"].item(), plan.gather_flat(met["grads"]).double(),
                              ref["tp_loss"], ref["tp_grads"])
        out["tp"] = dict(reading, mesh=[world // 2, 2], batch=PAR_TP_BATCH, loss=loss,
                         seconds=tp_s, launches=tp_counts,
                         controls=dict(dropout_left_out=no_dropout))
    finally:
        pm.destroy_process_group()
    return out


def parallel_cli_start() -> dict:
    """Phase parallel's CLI run, started now (`phase_parallel` (c)): its
    reference dir written, then `start_cli` at pl.trainer.devices=2 for one
    epoch of FIT_CONFIG with validation FID, under build/parallel_cli."""
    import shutil
    from pathlib import Path

    from sgdm_tpu_torch.data.synthetic import SyntheticImages
    from sgdm_tpu_torch.eval import harness

    root = Path(__file__).resolve().parent / "build" / "parallel_cli"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ref_dir = harness.generate_fid_reference_dir(
        SyntheticImages(size=64, num_classes=1000, length=PAR_FID_REF, seed=3,
                        cond_key="cluster"), root / "ref", PAR_FID_REF)
    cli_run = root / "cli"
    config = Path(__file__).resolve().parent / FIT_CONFIG
    argv = ["--config", str(config), "--device", "cuda", "pl.trainer.devices=2",
            "data.trainer.max_epochs=0", f"log_dir={cli_run}",
            f"data.fid_train_image_dir={ref_dir}", f"data.val_fid_num={PAR_FID_VAL_NUM}",
            "data.vis_every_iter=1000000000", "exp.cond_scale=false", "sg.params.debug=true",
            "pl.trainer.limit_val_batches=1"]
    return dict(root=root, ref_dir=ref_dir, run=cli_run, config=config, argv=argv,
                proc=start_cli(argv, root / "cli.log"))


def phase_parallel(dev, card: str, cli: dict | None = None) -> dict:
    """Training across ranks (`sgdm_tpu_torch/parallel`).  World 1 over NCCL
    in this process: the IN64 DDP step at batch 128 bit for bit against the
    bare step, and the FSDP step against the bare step on FSDP's route
    (einsum attention), launch counts exact.  Then `par_world` ranks
    (`parallel_rank`): PAR_STEPS DDP steps at global batch 128, dropout 0.1,
    against world 1 on the same batches (losses PAR_LOSS_TOL, the first
    gradient's cosine PAR_GRAD_COS and largest difference PAR_GRAD_REL,
    every parameter within Adam's bound a step), the ranks' parameters
    bit-equal; FSDP's per-rank state bytes; TP at (world/2, 2) on the plain
    route, one step at PAR_TP_BATCH against world 1 on that route (the same
    limits, PAR_TP_GRAD_REL for the gradient); the controls of
    `parallel_rank` fail them.  Last the CLI (a
    subprocess) at pl.trainer.devices=2 on FIT_CONFIG for one epoch: one checkpoint,
    restored at world 1 bit for bit; the _rank0 / _rank1 sample dirs; the
    validation FID of their statistics reduced across the ranks against one
    process's (PAR_FID_TOL).  ``cli``: that run as `parallel_cli_start`
    started it earlier (main starts it beside phase fid, whose time is the
    host's sqrtm); None: started here."""
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.config.engine import instantiate_from_config, load_config, to_container
    from sgdm_tpu_torch.eval import harness
    from sgdm_tpu_torch.eval.fid_engine import InceptionExtractor
    from sgdm_tpu_torch.eval.metrics import FeatureStats, frechet_distance
    from sgdm_tpu_torch.models.layers import set_routes
    from sgdm_tpu_torch.parallel import mesh as pm
    from sgdm_tpu_torch.parallel.fsdp import ALIGN, shard_train_state
    from sgdm_tpu_torch.parallel.launch import spawn
    from sgdm_tpu_torch.training.checkpoints import CheckpointManager, read_state
    from sgdm_tpu_torch.training.state import make_train_step

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "parallel"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cards = torch.cuda.device_count()
    world, backend = par_world(cards)
    print(json.dumps({"parallel_plan": dict(card=card, cards=cards, world=world,
                                            backend=backend)}), flush=True)

    # (a) world 1 over NCCL, in this process
    pm.init_process_group(dev, rank=0, world_size=1, init_method=f"file://{root / 'store1'}",
                          backend="nccl")
    try:
        mesh = pm.create_mesh(("data",))
        run = build_train(dev)
        model, tx, diffusion, batches = run["model"], run["tx"], run["diffusion"], run["batches"]
        bare = run["step"]
        ddp = make_train_step(model, diffusion, tx, cond_drop_prob=0.1, ema_decay=0.9999,
                              fused_optim=True, device=dev, mesh=mesh)
        base = run["state"].clone()
        rows, counts = {}, {}
        for name, step in (("bare", bare), ("ddp", ddp)):
            ops.reset_launch_counts()
            st, met = step(base.clone(), batches[0], seed=0)
            torch.cuda.synchronize()
            counts[name] = ops.launch_counts()
            rows[name] = (st, met["loss"].item())
        want = dict({k: 0 for k in META}, **TRAIN_LAUNCHES)
        (sb, lb), (sd, ld) = rows["bare"], rows["ddp"]
        ddp_equal = all(torch.equal(a, b) for a, b in (
            (sb.params, sd.params), (sb.ema_params, sd.ema_params),
            (sb.opt_state.mu, sd.opt_state.mu), (sb.opt_state.nu, sd.opt_state.nu)))
        del rows, sb, sd
        # FSDP at world 1 against the bare step, both on FSDP's route
        set_routes(model, flash=False)
        ops.reset_launch_counts()
        sb, mb = bare(base.clone(), batches[0], seed=0)
        torch.cuda.synchronize()
        counts["bare_fsdp_route"] = ops.launch_counts()
        fsdp = make_train_step(model, diffusion, tx, cond_drop_prob=0.1, ema_decay=0.9999,
                               fused_optim=True, device=dev, mesh=mesh)
        ops.reset_launch_counts()
        sf, mf = fsdp(shard_train_state(base.clone(), mesh), batches[0], seed=0)
        torch.cuda.synchronize()
        counts["fsdp"] = ops.launch_counts()
        fsdp_equal = all(torch.equal(a, b) for a, b in (
            (sb.params, sf.params), (sb.ema_params, sf.ema_params),
            (sb.opt_state.mu, sf.opt_state.mu), (sb.opt_state.nu, sf.opt_state.nu)))
        want_fsdp = dict(want, flash_attention_fwd=0, flash_attention_bwd=0)
        del sb, sf
        # FSDP's route at world 1, ms a step: the bare step, then FSDP's
        _, _, _, ms_route1 = par_steps(bare, base.clone(), batches, PAR_FSDP_STEPS,
                                       grads_at=None)
        st, fsdp_ref, _, ms_fsdp1 = par_steps(fsdp, shard_train_state(base.clone(), mesh),
                                              batches, PAR_FSDP_STEPS, grads_at=None)
        del st, fsdp
        set_routes(model, flash=True)
        # world 1's DDP steps: ms a step, and the reference of the multi-rank run
        ops.reset_launch_counts()
        st1, losses1, grads1, ms1 = par_steps(ddp, base.clone(), batches, PAR_STEPS)
        counts["ddp_steps"] = ops.launch_counts()
        grad = torch.zeros(N_PARAMS_IN64, dtype=torch.float32, device=dev)
        nccl_ms = cuda_time(lambda: torch.distributed.all_reduce(grad), PAR_ALLREDUCE_ITERS)
        del ddp, bare, run
        # world 1 on TP's route, at its batch
        tp_run = par_tp_model(dev)
        with composition_route():
            tst, tmet = tp_run["step"](tp_run["state"], tp_run["batches"][0], seed=0,
                                       return_grads=True)
        torch.save({"losses": losses1, "params": st1.params, "grads": grads1,
                    "fsdp_losses": fsdp_ref, "tp_loss": tmet["loss"].item(),
                    "tp_grads": tmet["grads"].double()}, root / "world1.pt")
        del tp_run, tst, tmet, st1, grads1, base, model
    finally:
        pm.destroy_process_group()
    torch.cuda.empty_cache()
    row1 = dict(card=card, backend="nccl", world=1, batch=TRAIN_BATCH, ddp_bit_equal=ddp_equal,
                loss=ld, fsdp_bit_equal=fsdp_equal, launches=counts,
                ms_per_step=ms1, losses=losses1, ms_per_step_fsdp_route_bare=ms_route1,
                ms_per_step_fsdp=ms_fsdp1, allreduce_bytes=4 * N_PARAMS_IN64,
                nccl_allreduce_ms_one_rank=nccl_ms)
    print(json.dumps({"parallel_world1": row1}), flush=True)
    assert ddp_equal and ld == lb, row1
    assert fsdp_equal and mf["loss"].item() == mb["loss"].item(), row1
    assert counts["bare"] == counts["ddp"] == want, counts
    assert counts["fsdp"] == counts["bare_fsdp_route"] == want_fsdp, counts
    assert counts["ddp_steps"] == {k: PAR_STEPS * v for k, v in want.items()}, counts

    # (b) world N in spawned ranks
    t0 = time.perf_counter()
    ranks = spawn(parallel_rank, world, (world, backend, str(root / "storeN"),
                                         str(root / "world1.pt")), timeout=PAR_RANK_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    r0 = ranks[0]
    want_n = {k: PAR_STEPS * v for k, v in want.items()}
    bound = 2 * PAR_STEPS * adam_step_bound(1.0)
    rowN = dict(card=card, backend=backend, world=world, batch=TRAIN_BATCH,
                collective=("NCCL between cards" if backend == "nccl" else
                            "gloo through host memory: not DDP's cost on NCCL"),
                seconds=ranks_s, ddp=[r["ddp"] for r in ranks], fsdp=[r["fsdp"] for r in ranks],
                tp=r0["tp"], loss_tol=PAR_LOSS_TOL, grad_cos_min=PAR_GRAD_COS,
                grad_rel_max=PAR_GRAD_REL, tp_grad_rel_max=PAR_TP_GRAD_REL, param_bound=bound)
    print(json.dumps({"parallel_world": rowN}), flush=True)
    for r in ranks:
        d = r["ddp"]
        assert d["launches"] == want_n, (r["rank"], d["launches"])
        assert d["params_equal_rank0"], r["rank"]
        assert par_within(d), d
        assert d["param_max_abs_diff"] <= bound, d
        assert not any(par_within(c) for c in d["controls"].values()), d["controls"]
        f = r["fsdp"]
        assert f["launches"]["flash_attention_fwd"] == 0, f
        assert f["launches"]["adamw_ema"] == PAR_FSDP_STEPS, f
        assert f["bytes_per_rank"]["mu"] <= f["bytes_one_rank"]["mu"] / world + 4 * ALIGN, f
        assert f["loss_rel_diff"] <= PAR_LOSS_TOL, f
    t = r0["tp"]
    assert par_within(t, PAR_TP_GRAD_REL), t
    assert not any(par_within(c, PAR_TP_GRAD_REL) for c in t["controls"].values()), t["controls"]
    assert t["launches"]["resblock_train"] == t["launches"]["resblock_bwd"] == 0, t

    # (c) the CLI at pl.trainer.devices=2 for one epoch, with validation FID
    cli = cli or parallel_cli_start()
    ref_dir, cli_run, config, argv = cli["ref_dir"], cli["run"], cli["config"], cli["argv"]
    rc, err, cli_s = finish_cli(cli["proc"], PAR_RANK_TIMEOUT)
    assert rc == 0, err[-4000:]
    meta = json.loads((cli_run / "ckpts" / "meta.json").read_text())
    host = read_state(cli_run / "ckpts" / "last")
    cfg = load_config(str(config), [*argv[4:], "pl.trainer.devices=1"])
    sg = to_container(cfg.sg.params)
    sg.update(pl=to_container(cfg.pl), data=to_container(cfg.data), seed=int(cfg.select("seed")))
    trainer = instantiate_from_config({"target": cfg.sg.target, "params": sg}, device=dev)
    trainer._init_state()
    state = CheckpointManager(cli_run / "ckpts").restore(trainer.state)
    restored_equal = all(torch.equal(flat.cpu(), host[k]) for k, flat in (
        ("params", state.params), ("ema_params", state.ema_params),
        ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)))
    del trainer, state
    dirs = [cli_run / f"val_samples_ep0_rank{r}" for r in (0, 1)]
    n_imgs = [len(list(d.glob("img*.png"))) for d in dirs]
    recs = [json.loads(line) for line in (cli_run / "metrics.jsonl").read_text().splitlines()]
    logged = [r["val/clean_fid_raw"] for r in recs if "val/clean_fid_raw" in r]
    ex = InceptionExtractor(device=dev)
    one, real = FeatureStats(), FeatureStats()
    for d in dirs:
        one.append(ex.features_from_dir(d)["pool3"])
    real.append(ex.features_from_dir(ref_dir)["pool3"])
    fid_one = frechet_distance(*one.mean_cov(), *real.mean_cov())
    row_cli = dict(card=card, seconds=cli_s, ranks=2, backend="nccl" if cards >= 2 else "gloo",
                   steps=host["step"], last=Path(meta["last_path"]).name,
                   restored_bit_equal=restored_equal, sample_images=n_imgs,
                   fid_logged=logged, fid_one_process=fid_one, fid_tol=PAR_FID_TOL)
    print(json.dumps({"parallel_cli": row_cli}), flush=True)
    assert restored_equal and meta["last_epoch"] == 0, row_cli
    assert host["step"] == FIT_STEPS_PER_EPOCH, row_cli
    assert not (cli_run / "ckpts" / "last-1").exists(), row_cli
    assert n_imgs == [PAR_FID_SAMPLES // 2] * 2, row_cli
    assert len(logged) == 1 and abs(logged[0] - fid_one) <= PAR_FID_TOL * abs(fid_one), row_cli
    assert all(np.isfinite(r["train/loss"]) for r in recs if "train/loss" in r), row_cli
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(cli["root"], ignore_errors=True)
    harness._EXTRACTORS.clear()
    print(json.dumps({"parallel_phase": dict(card=card, seconds=time.perf_counter() - t_phase)}),
          flush=True)
    return {"parallel": counts["ddp"]}


# ---------------------------------------------------------------- phase 11

def classifier_launches(train_steps: int, eval_forwards: int) -> dict:
    """Exact launches of the classifier path: K9 on f32 operands, 3 + 3 a
    train step and 3 an eval forward; nothing else."""
    return dict({k: 0 for k in META}, flash_attention_fwd_f32=CLS_K9 * (train_steps + eval_forwards),
                flash_attention_bwd_f32=CLS_K9 * train_steps)


def classifier_step_bound(model, sched, x, labels, t, noise) -> dict:
    """The least time of one train step's operations on an H100: the
    convolutions and products PyTorch runs (counted by FlopCounterMode:
    convolutions at the TF32 peak, which cuDNN takes by default for f32;
    the rest at the f32 peak) and K9's (forward 4·N²·D, backward 10·N²·D a
    head, at the f32 peak: FFMA)."""
    from torch.utils.flop_counter import FlopCounterMode

    from sgdm_tpu_torch.training import classifier as cls

    with FlopCounterMode(display=False) as fc:
        loss, _ = cls._loss(model, sched, x, labels, t, noise, True)
        loss.backward()
    model.zero_grad(set_to_none=True)
    counts = fc.get_flop_counts().get("Global", {})
    conv = sum(v for op, v in counts.items() if "convolution" in str(op))
    rest = sum(v for op, v in counts.items() if "convolution" not in str(op))
    b, nh, n, d = K9_F32_SHAPE
    attn = CLS_K9 * 14.0 * b * nh * n * n * d
    ms = (conv / TF32_FLOP_PER_S + (rest + attn) / F32_FLOP_PER_S) * 1e3
    return dict(bound_ms=ms, bound_by="operations", conv_flop=conv, other_flop=rest,
                k9_flop=attn)


def phase_classifier(dev, card: str) -> dict:
    """The noisy-image classifier on the card (module docstring, 11)."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.diffusion.schedule import DiffusionSchedule
    from sgdm_tpu_torch.models.encoder_unet import EncoderUNetModel
    from sgdm_tpu_torch.models.factory import init_random_params
    from sgdm_tpu_torch.models.layers import set_kernels
    from sgdm_tpu_torch.training import classifier as cls
    from sgdm_tpu_torch.training.optim import create_optimizer

    t_phase = time.perf_counter()
    sched = DiffusionSchedule.create(num_timesteps=CLS_T)
    rng = np.random.default_rng(0)
    shape = (CLS_BATCH, CLS_PX, CLS_PX, 3)
    x = torch.as_tensor(rng.uniform(-1, 1, shape), dtype=torch.float32, device=dev)
    labels = torch.as_tensor(rng.integers(0, CLS_CLASSES, CLS_BATCH), device=dev)
    t = torch.as_tensor(rng.integers(0, CLS_T, CLS_BATCH), device=dev)
    noise = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
    rows = {}
    for pool in ("adaptive", "spatial"):
        model = EncoderUNetModel(num_classes=CLS_CLASSES, pool=pool)
        with torch.no_grad():  # every weight nonzero: attention's proj_out and the head too
            init_random_params(model, 11)
        tx = create_optimizer("adamw", lr=1e-4, wd=1e-2, scheduler=None)
        state = cls.create_classifier_state(model, tx, device=dev)
        # (a) kernels on vs off, one state, one draw, TF32 off on both sides
        res = {}
        with full_f32():
            for on in (True, False):
                set_kernels(model, on)
                model.zero_grad(set_to_none=True)
                loss, logits = cls._loss(model, sched, x, labels, t, noise, True)
                loss.backward()
                _, elogits = cls.make_classifier_eval_step(model, sched, device=dev)(
                    x, labels, t, noise=noise)
                res[on] = (loss.item(), {n: p.grad.double() for n, p in model.named_parameters()},
                           elogits)
            set_kernels(model, True)
        g_on = torch.cat([g.reshape(-1) for g in res[True][1].values()])
        g_off = torch.cat([g.reshape(-1) for g in res[False][1].values()])
        leaf = {n: rel_err(res[True][1][n], g) for n, g in res[False][1].items()
                if g.abs().max() > 0}
        worst = max(leaf, key=leaf.get)
        check = dict(loss_kernels=res[True][0], loss_plain=res[False][0],
                     loss_rel_diff=abs(res[True][0] - res[False][0]) / abs(res[False][0]),
                     grad_cosine=(g_on @ g_off / (g_on.norm() * g_off.norm())).item(),
                     worst_leaf=worst, worst_leaf_rel_err=leaf[worst],
                     eval_logits_rel_err=rel_err(res[True][2], res[False][2]))
        del res, g_on, g_off
        model.zero_grad(set_to_none=True)
        assert math.isfinite(check["loss_kernels"]), check
        assert check["loss_rel_diff"] <= CLS_LOSS_TOL, check
        assert check["grad_cosine"] >= CLS_GRAD_COS, check
        assert check["worst_leaf_rel_err"] <= CLS_LEAF_TOL, check
        assert check["eval_logits_rel_err"] <= CLS_LOGIT_TOL, check
        bound = classifier_step_bound(model, sched, x, labels, t, noise)
        # (b) train steps: counters at 0, warm-up and timed steps, counters read
        step = cls.make_classifier_train_step(model, sched, tx, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        losses = []
        for i in range(CLS_STEPS_WARMUP + CLS_STEPS_TIMED):
            if i == CLS_STEPS_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, loss, _ = step(state, x, labels, gen)
            losses.append(loss)
        torch.cuda.synchronize()
        s_step = (time.perf_counter() - t0) / CLS_STEPS_TIMED
        counts = ops.launch_counts()
        assert counts == classifier_launches(CLS_STEPS_WARMUP + CLS_STEPS_TIMED, 0), counts
        losses = torch.stack(losses).cpu()
        assert bool(torch.isfinite(losses).all()), losses
        # (c) the per-noise-level table on CLS_VAL_BATCHES batches
        val = [{"image": rng.uniform(-1, 1, shape).astype(np.float32),
                "label": np.eye(CLS_CLASSES, dtype=np.float32)[rng.integers(0, CLS_CLASSES,
                                                                              CLS_BATCH)]}
               for _ in range(CLS_VAL_BATCHES)]
        evaluate = cls.make_classifier_eval_step(model, sched, device=dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        table = cls.noise_accuracy_table(evaluate, val, CLS_T, CLS_LOG_STEPS, lambda sh: noise)
        torch.cuda.synchronize()
        table_s = time.perf_counter() - t0
        grid = len(cls.timestep_grid(CLS_T, CLS_LOG_STEPS))
        eval_counts = ops.launch_counts()
        assert eval_counts == classifier_launches(0, CLS_VAL_BATCHES * grid), eval_counts
        # (d) the checkpoint: flax's msgpack bytes, read back into a fresh model
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            path = cls.save_checkpoint(model, Path(d) / "c.msgpack")
            save_s = time.perf_counter() - t0
            fresh = cls.load_checkpoint(EncoderUNetModel(num_classes=CLS_CLASSES, pool=pool), path)
            same = all(torch.equal(a, b.cpu()) for a, b in zip(fresh.parameters(),
                                                               model.parameters()))
            nbytes = path.stat().st_size
        assert same
        rows[pool] = dict(kernels_vs_plain=check, s_per_step=s_step,
                          samples_per_s=CLS_BATCH / s_step, **bound,
                          bound_share=bound["bound_ms"] / (s_step * 1e3),
                          losses=losses.tolist(), launches=counts,
                          peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                          table=table, table_seconds=table_s, table_launches=eval_counts,
                          checkpoint_bytes=nbytes, checkpoint_save_s=save_s,
                          checkpoint_round_trip=same,
                          params=sum(p.numel() for p in model.parameters()))
        print(json.dumps({f"classifier_{pool}": rows[pool]}), flush=True)
        del model, state, step, fresh
        torch.cuda.empty_cache()
    # (e) the CLI, the path a user runs: counters at 0 just before, read just after
    with tempfile.TemporaryDirectory() as d:
        records = []
        argv = ["--arch", "full", "--channels", "128", "--image-size", str(CLS_PX),
                "--num-classes", str(CLS_CLASSES), "--num-timesteps", str(CLS_T),
                "--batch-size", str(CLS_BATCH), "--data-len", str(CLS_CLI_DATA),
                "--workers", "8", "--log-every", "1", "--log-steps", str(CLS_LOG_STEPS),
                "--out", str(Path(d) / "noisy_classifier.msgpack")]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = cls.train_classifier(cls.build_argparser().parse_args(argv), records.append)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        nbytes = out.stat().st_size
    steps = CLS_CLI_DATA // CLS_BATCH
    val_batches = CLS_CLI_DATA // 4 // CLS_BATCH
    want = classifier_launches(steps, val_batches * CLS_LOG_STEPS)
    tables = [r for r in records if "acc1_by_noise_level" in r]
    row = dict(card=card, argv=argv, seconds=cli_s, steps=steps,
               losses=[r["loss"] for r in records if "loss" in r],
               table=tables[-1]["acc1_by_noise_level"] if tables else None,
               train_seconds=tables[-1]["train_seconds"] if tables else None,
               checkpoint_bytes=nbytes, launches=counts,
               phase_seconds=time.perf_counter() - t_phase)
    print(json.dumps({"classifier_cli": row}), flush=True)
    assert counts == want, f"classifier: launch counts {counts} != {want}"
    assert len(row["losses"]) == steps and all(math.isfinite(v) for v in row["losses"]), row
    return {"classifier": counts}


def smooth_image(rng, h: int, w: int):
    """uint8 [h, w, 3]: sinusoids plus noise (PNG-compresses like a photo)."""
    import numpy as np

    y, x = np.ogrid[0:h, 0:w]
    planes = [127 + 70 * np.sin(x * rng.uniform(0.005, 0.05) + y * rng.uniform(0.005, 0.05) + c)
              + rng.normal(0, 6, (h, w)) for c in range(3)]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def write_cityscapes_tree(root, n_train: int, n_val: int, seed: int = 0) -> dict:
    """A Cityscapes tree under ``root``: ``leftImg8bit/{split}/<city>/
    <city>_<i>_000019_leftImg8bit.png`` (CS_SIZE RGB PNGs by the port's
    writer, row filters cycling 0-4; CS_DISTINCT distinct images, each
    hard-linked under its share of the names) and the matching ``gtFine/
    {split}/<city>/…_gtFine_labelIds.png`` (grey, ids 0..33 and 255)."""
    import os

    import numpy as np

    from sgdm_tpu_torch.utils.png import write_png

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    h, w = CS_SIZE
    src = root / "distinct"
    src.mkdir(parents=True)
    filters = [r % 5 for r in range(h)]
    for j, m in enumerate(id_masks(rng, h, w, CS_DISTINCT, 34, cell=64)):
        write_png(src / f"{j}.png", smooth_image(rng, h, w), filters)
        write_png(src / f"{j}_ids.png", m, filters)
    i = 0
    for split, n in (("train", n_train), ("val", n_val)):
        for _ in range(n):
            city = ("aachen", "bochum", "bremen", "cologne")[i % 4]
            stem = f"{city}_{i:06d}_000019"
            for kind, name in (("leftImg8bit", f"{stem}_leftImg8bit.png"),
                               ("gtFine", f"{stem}_gtFine_labelIds.png")):
                d = root / kind / split / city
                d.mkdir(parents=True, exist_ok=True)
                os.link(src / (f"{i % CS_DISTINCT}.png" if kind == "leftImg8bit"
                               else f"{i % CS_DISTINCT}_ids.png"), d / name)
            i += 1
    return dict(names=i, seconds=time.perf_counter() - t0,
                distinct_bytes=sum(p.stat().st_size for p in src.iterdir()))


def write_coco14_tree(root, n_train: int, n_val: int, seed: int = 0) -> dict:
    """A COCO 2014 tree under ``root``: ``{split}2014/COCO_{split}2014_<id>.jpg``
    (the VOC-size fixtures' bytes, hard-linked) and ``annotations/
    instances_{split}2014.json`` with COCO7C_POLYS star-shaped polygon
    instances an image (6-40 float vertices, 80 categories of COCO's ids)
    and one crowd (RLE) instance, which the reader skips."""
    import os

    import numpy as np

    from sgdm_tpu_torch.utils.jpeg import jpeg_header

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    (root / "annotations").mkdir(parents=True)
    (root / "fixtures").mkdir()
    sizes = []
    for f in VOC_FIXTURES:
        (root / "fixtures" / f"{f}.jpg").write_bytes(fixture_bytes(f))
        sizes.append(jpeg_header(fixture_bytes(f))[:2])
    cat_ids = [i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
    cats = [{"id": c, "name": f"c{c}"} for c in cat_ids]
    i, aid = 0, 0
    for split, n in (("train", n_train), ("val", n_val)):
        (root / f"{split}2014").mkdir()
        images, anns = [], []
        for _ in range(n):
            f = i % len(VOC_FIXTURES)
            w, h = sizes[f]
            name = f"COCO_{split}2014_{i:012d}.jpg"
            os.link(root / "fixtures" / f"{VOC_FIXTURES[f]}.jpg", root / f"{split}2014" / name)
            images.append(dict(id=i, file_name=name, width=w, height=h))
            for _ in range(COCO7C_POLYS):
                k = int(rng.integers(6, 41))
                c = rng.uniform([0, 0], [w, h])
                ang = np.sort(rng.uniform(0, 2 * np.pi, k))
                r = rng.uniform(4, min(w, h) / 3, k)
                poly = np.round(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1), 2)
                aid += 1
                anns.append(dict(id=aid, image_id=i, category_id=int(rng.choice(cat_ids)),
                                 area=float(rng.uniform(16, w * h / 4)), iscrowd=0,
                                 segmentation=[poly.reshape(-1).tolist()]))
            aid += 1
            anns.append(dict(id=aid, image_id=i, category_id=1, area=float(w * h), iscrowd=1,
                             segmentation={"counts": [0, w * h], "size": [h, w]}))
            i += 1
        (root / "annotations" / f"instances_{split}2014.json").write_text(json.dumps(
            dict(images=images, annotations=anns, categories=cats)))
    return dict(names=i, seconds=time.perf_counter() - t0)


def phase_data7c(card: str, train_step_s: float | None = None) -> dict:
    """Item 7c's readers and the resize CLI on the card's host (module
    docstring, 12); ``train_step_s``: phase train's IN64 step, whose rate
    at batch 128 the readers are set against."""
    import os
    import shutil
    from pathlib import Path

    import numpy as np

    from sgdm_tpu_torch.data import imagenet_downsample
    from sgdm_tpu_torch.data.cityscapes import CityscapesDataset
    from sgdm_tpu_torch.data.coco14 import Coco14Dataset
    from sgdm_tpu_torch.data.loader import DataLoader
    from sgdm_tpu_torch.utils.png import read_png

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "data7c"
    shutil.rmtree(root, ignore_errors=True)
    rows = {}
    # the rate a train step at batch 128 needs: phase train's step when it ran
    need = TRAIN_BATCH / train_step_s if train_step_s else None
    kw = dict(image_size=64, size4cluster=320, condition_method="layout",
              condition={"layout": {"how": "oracle"}})
    for name, writer, cls_, n_train, n_val, classes in (
            ("cs64", write_cityscapes_tree, CityscapesDataset, CS_TRAIN, CS_VAL, 27),
            ("coco64", write_coco14_tree, Coco14Dataset, COCO7C_TRAIN, COCO7C_VAL, 81)):
        tree = root / name
        tree.mkdir(parents=True)
        written = writer(tree, n_train, n_val)
        ds = cls_(str(tree), split="train", **kw)
        val = cls_(str(tree), split="val", **kw)
        assert len(ds) == n_train and len(val) == n_val, (name, len(ds), len(val))
        sample = val[0]
        assert sample["segmask"].shape == (64, 64, classes) and sample["image"].shape == (64, 64, 3)
        assert np.array_equal(sample["attr"], sample["segmask"].max(axis=(0, 1)))
        t0 = time.perf_counter()
        for j in range(8):
            val[j % n_val]
        getitem_ms = (time.perf_counter() - t0) * 1e3 / 8
        dl = DataLoader(ds, TRAIN_BATCH, shuffle=True, num_workers=DATA7C_THREADS)
        first, rate = loader_rate(dl, DATA7C_BATCHES)
        assert first["image"].shape == (TRAIN_BATCH, 64, 64, 3), first["image"].shape
        rows[name] = dict(tree=written, getitem_ms=getitem_ms, threads=DATA7C_THREADS,
                          images_per_s=rate, images_per_s_needed=need,
                          classes_seen=int((first["attr"].sum(0) > 0).sum()))
        print(json.dumps({f"data7c_{name}": rows[name]}), flush=True)
        shutil.rmtree(tree)
    # imagenet_downsample resize: JPEG fixtures to 64 px by the box filter
    src, out = root / "resize_in", root / "resize_out"
    src.mkdir(parents=True)
    names = [f for f in VOC_FIXTURES + COCO_FIXTURES]
    for f in names:
        (src / f"{f}.jpg").write_bytes(fixture_bytes(f))
    for j in range(RESIZE_FILES - len(names)):
        os.link(src / f"{names[j % len(names)]}.jpg", src / f"n{j:05d}.JPEG")
    t0 = time.perf_counter()
    imagenet_downsample.main(["resize", "--in_dir", str(src), "--out_dir", str(out),
                              "--size", "64"])
    resize_s = time.perf_counter() - t0
    outs = sorted(out.glob("*.png"))
    assert len(outs) == RESIZE_FILES and read_png(outs[0]).shape == (64, 64, 3), len(outs)
    rows["resize"] = dict(files=RESIZE_FILES, seconds=resize_s,
                          images_per_s=RESIZE_FILES / resize_s, alg="box", size=64)
    shutil.rmtree(root, ignore_errors=True)
    row = dict(card=card, cpu_count=os.cpu_count(), **rows,
               phase_seconds=time.perf_counter() - t_phase)
    print(json.dumps({"data7c": row}), flush=True)
    return row


def phase_profile_train(dev, steps: int = 2, family: str = "unet") -> None:
    """torch.profiler over ``steps`` train steps after a warm-up step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run = build_train(dev, family)
    state, step, batches = run["state"], run["step"], run["batches"]
    state, _ = step(state, batches[0], seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            state, _ = step(state, batches[i % len(batches)], seed=0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    tag = "profile_train" if family == "unet" else "profile_train_ca"
    print(json.dumps({tag: dict(steps=steps, **profile_rows(prof, wall_us))}), flush=True)


# ---------------------------------------------------------------- phase 13

def vdiff_bound(model, batch: int) -> dict:
    """Least time of one forward at ``batch``: FlopCounterMode's FLOPs at the
    f32 peak against the weights plus every convolution's and linear's input
    and output (each read or written once) at HBM rate, counted on the meta
    device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from sgdm_tpu_torch.models.zoo_vdiff import VDiffUNet

    with torch.device("meta"):
        meta = VDiffUNet(model.cfg)
        x, t = torch.empty(batch, 3, model.cfg.size, model.cfg.size), torch.empty(batch)
        ce = torch.empty(batch, model.cfg.clip_dim)
    act = [0]

    def count(mod, inp, out):
        act[0] += (inp[0].numel() + out.numel()) * 4

    hooks = [m.register_forward_hook(count) for m in meta.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        meta(x, t, ce)
    for h in hooks:
        h.remove()
    flops = float(fc.get_total_flops())
    nbytes = 4.0 * sum(p.numel() for p in meta.parameters()) + act[0]
    ms, by = bound_ms(nbytes, flops, F32_FLOP_PER_S)
    return dict(flops=flops, bytes=nbytes, bound_ms=ms, bound_by=by)


def phase_vdiff(dev, card: str) -> dict:
    """v-diffusion serving at cc12m_1_cfg's full width (module docstring, 13)."""
    import os
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.device import no_tf32
    from sgdm_tpu_torch.diffusion import vdiff_cli as vc
    from sgdm_tpu_torch.models import zoo_vdiff as zv
    from sgdm_tpu_torch.utils.image import read_image

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root, cwd = Path(tmp.name), os.getcwd()
    ckpt = root / f"{VDIFF_MODEL}.pth"
    row: dict = dict(card=card, model=VDIFF_MODEL)

    # 1. the checkpoint: seeded random weights in the published keys
    t = time.perf_counter()
    torch.manual_seed(VDIFF_SEED)
    model, meta = zv.get_vdiff_model(VDIFF_MODEL, dev)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
    row["checkpoint"] = dict(parameters=sum(p.numel() for p in model.parameters()),
                             bytes=ckpt.stat().st_size, write_s=time.perf_counter() - t)
    del model

    # 2. one forward, card against CPU; ms a forward beside the bound.  The
    # process's first meta-device build pays torch's lazy imports (the CLI
    # pays them once, checking its arguments): timed apart from the load
    t = time.perf_counter()
    zv.get_vdiff_model(VDIFF_MODEL, "meta")
    first_meta_s = time.perf_counter() - t
    t = time.perf_counter()
    model = zv.load_vdiff_torch_checkpoint(VDIFF_MODEL, str(ckpt), dev)
    load_s = time.perf_counter() - t
    rng = np.random.default_rng(1)
    size = meta.shape[0]
    x = torch.as_tensor(rng.standard_normal((1, 3, size, size)), dtype=torch.float32)
    tt = torch.as_tensor([0.6], dtype=torch.float32)
    ce = torch.as_tensor(rng.standard_normal((1, meta.clip_dim)), dtype=torch.float32)
    with torch.no_grad(), no_tf32():
        v_card = model(x.to(dev), tt.to(dev), ce.to(dev)).cpu()
    with torch.no_grad():
        v_tf32 = tf32_on(lambda: model(x.to(dev), tt.to(dev), ce.to(dev))).cpu()
    t = time.perf_counter()
    cpu = zv.load_vdiff_torch_checkpoint(VDIFF_MODEL, str(ckpt), "cpu")
    with torch.no_grad():
        v_cpu = cpu(x, tt, ce)
    cpu_s = time.perf_counter() - t
    del cpu
    scale = float(v_cpu.abs().max())
    err = float((v_card - v_cpu).abs().max()) / scale
    tf32_err = float((v_tf32 - v_cpu).abs().max()) / scale
    timed = {}
    for b in VDIFF_TIMED:
        xb, tb, cb = (z.to(dev).repeat(b, *[1] * (z.ndim - 1)) for z in (x, tt, ce))
        with torch.no_grad(), no_tf32():
            ms = cuda_time(lambda: model(xb, tb, cb), 3 if b > 1 else 5, warmup=1)
        timed[b] = dict(ms=ms, **vdiff_bound(model, b))
        timed[b]["of_bound"] = timed[b]["bound_ms"] / ms
    del model
    torch.cuda.empty_cache()
    row["forward"] = dict(first_meta_build_s=first_meta_s, load_s=load_s, rel_err=err,
                          tol=VDIFF_TOL, tf32_rel_err=tf32_err, cpu_forward_s=cpu_s,
                          finite=bool(torch.isfinite(v_card).all()),
                          batches={str(b): r for b, r in timed.items()})
    print(json.dumps({"vdiff_forward": row["forward"]}), flush=True)
    assert row["forward"]["finite"] and err <= VDIFF_TOL < tf32_err, row["forward"]

    # 3-6. the CLI from the .pth, the counters at 0 just before and read just after
    np.save(root / "e.npy", rng.standard_normal(meta.clip_dim).astype(np.float32))
    loaded, forwards, finite = [], [0], []
    load_model, to_image = vc._load_model, vc._to_image

    def counted_load(args, d):
        m = load_model(args, d)
        m.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
        torch.cuda.synchronize()
        loaded.append(time.perf_counter())
        return m

    def checked_image(xf):
        finite.append(bool(np.isfinite(xf).all()))
        return to_image(xf)

    def cli(*argv) -> dict:
        forwards[0] = 0
        t0 = time.perf_counter()
        vc.main(list(argv))
        wall = time.perf_counter() - t0
        return dict(wall_s=wall, sample_s=time.perf_counter() - loaded[-1], forwards=forwards[0])

    common = ("--checkpoint", str(ckpt), "--seed", "0")
    os.chdir(root)
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with patched(vc, "_load_model", counted_load), patched(vc, "_to_image", checked_image):
            cfg = cli("cfg-sample", "--embed", "e.npy:3", "-n", str(VDIFF_CFG_N), "-bs",
                      str(VDIFF_CFG_N), "--steps", str(VDIFF_CFG_STEPS), "--clip-encoder",
                      "none", *common)
            outs = [f"out_{i:05}.png" for i in range(VDIFF_CFG_N)]
            imgs = [read_image(p) for p in outs]
            cfg.update(forwards_per_s=cfg["forwards"] / cfg["sample_s"],
                       images_per_s=VDIFF_CFG_N / cfg["sample_s"], cfg_batch=2 * VDIFF_CFG_N,
                       shapes=sorted({i.shape for i in imgs}))
            for p in outs:
                os.rename(p, f"cfg_{p}")
            clip_args = ("clip-sample", "--model", "cc12m_1", "--embed", "e.npy", "--method",
                         "ddim", "--steps", str(VDIFF_CLIP_STEPS), "--cutn", str(VDIFF_CUTN),
                         "-n", "1", *common)
            torch.cuda.reset_peak_memory_stats(dev)
            guided = cli(*clip_args, "-cs", str(VDIFF_CS))
            guided.update(s_per_guided_step=guided["sample_s"] / VDIFF_CLIP_STEPS,
                          peak_bytes=torch.cuda.max_memory_allocated(dev))
            g_img = read_image("out_00000.png")
            plain = cli(*clip_args, "-cs", "0")
            guided["differs_from_unguided"] = bool((read_image("out_00000.png") != g_img).any())
            guided["unguided_sample_s"] = plain["sample_s"]
            modify = cli("modify-image", "cfg_out_00000.png", "--embed", "e.npy:3", "--steps",
                         str(VDIFF_MODIFY_STEPS), "--clip-encoder", "none", "-o", "mod.png",
                         *common)
            modify["shape"] = list(read_image("mod.png").shape)
        vc.main(["make-grid", *[f"cfg_{p}" for p in outs], "-o", "grid.png"])
        grid = read_image("grid.png")
        tiles_equal = all(np.array_equal(grid[size * (i // 2):size * (i // 2 + 1),
                                              size * (i % 2):size * (i % 2 + 1)], img)
                          for i, img in enumerate(imgs))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        os.chdir(cwd)
        tmp.cleanup()
    row.update(cfg_sample=cfg, clip_sample=guided, modify_image=modify,
               make_grid=dict(shape=list(grid.shape), tiles_equal=tiles_equal),
               outputs_finite=all(finite), outputs=len(finite), launches=counts,
               phase_seconds=time.perf_counter() - t_phase)
    print(json.dumps({"vdiff": row}), flush=True)
    assert cfg["shapes"] == [(size, size, 3)] and cfg["forwards"] == VDIFF_CFG_FORWARDS, cfg
    assert guided["differs_from_unguided"], guided
    assert modify["shape"] == [size, size, 3], modify
    assert tiles_equal and list(grid.shape) == [2 * size, 2 * size, 3], grid.shape
    assert all(finite) and len(finite) == VDIFF_CFG_N + 3, finite
    assert not any(counts.values()), counts
    return {"vdiff": counts}


def ssl_timed(factory, rec: dict):
    """``factory`` (a make_*_train_step) wrapped: the step it makes counts its
    first call's FLOPs under FlopCounterMode and brackets every later call
    with CUDA events; ``rec`` keeps the factory's arguments."""
    def make(*a, **k):
        import torch
        from torch.utils.flop_counter import FlopCounterMode

        step = factory(*a, **k)
        rec["args"] = a

        def run(*sa, **sk):
            if "flops" not in rec:
                with FlopCounterMode(display=False) as fc:
                    out = step(*sa, **sk)
                rec["flops"] = float(fc.get_total_flops())
                return out
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = step(*sa, **sk)
            e.record()
            rec.setdefault("events", []).append((s, e))
            return out

        run.opt_state = step.opt_state
        return run

    return make


def ssl_step_row(rec: dict, batch: int, peak_bytes: int, data_rate: float) -> dict:
    """ms a step (median of the timed steps) beside its bound, the step's
    images/s beside the host dataset's, peak memory."""
    import torch

    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in rec["events"])
    med = ms[len(ms) // 2]
    bound, by = bound_ms(0.0, rec["flops"], F32_FLOP_PER_S)
    return dict(ms_per_step=med, ms_all=ms, flops=rec["flops"], bound_ms=bound, bound_by=by,
                of_bound=bound / med, step_images_per_s=batch * 1e3 / med,
                dataset_images_per_s=data_rate, peak_bytes=peak_bytes)


def ssl_dataset_rate(ds, batch: int, batches: int = 2) -> float:
    """images/s of ``ds`` through the trainers' loader (SSL_WORKERS threads)."""
    from sgdm_tpu_torch.data.loader import DataLoader

    dl = DataLoader(ds, batch_size=batch, shuffle=True, num_workers=SSL_WORKERS, seed=1)
    t = time.perf_counter()
    n = 0
    for i, b in enumerate(dl):
        n += len(next(iter(b.values())))
        if i + 1 == batches:
            break
    return n / (time.perf_counter() - t)


def ssl_card_vs_cpu(dev, build, make_step, run_step) -> dict:
    """One step of ``make_step(model)`` on the card and on the CPU from the
    same weights (``build()``, made on the CPU) and fed draws: the loss's
    relative difference (and the TF32 reading of the card's loss, which must
    exceed the limit), and the parameters after the update."""
    import copy

    import torch

    from sgdm_tpu_torch.device import no_tf32

    t = time.perf_counter()
    cpu = build()
    card = copy.deepcopy(cpu).to(dev)
    before = [p.detach().clone() for p in cpu.parameters()]
    with torch.no_grad():
        loss_tf32 = float(tf32_on(lambda: run_step(card, None, dev, loss_only=True)))
    with no_tf32():
        loss_card = float(run_step(card, make_step(card), dev))
    loss_cpu = float(run_step(cpu, make_step(cpu), torch.device("cpu")))
    off, total, worst = 0, 0, 0.0
    for p_card, p_cpu, p0 in zip(card.parameters(), cpu.parameters(), before):
        d = (p_card.detach().cpu() - p_cpu.detach()).abs()
        off += int((d > 1e-3 * SSL_CMP_LR).sum())
        total += d.numel()
        worst = max(worst, float(d.max()))
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(cpu.parameters(), before))
    del card
    torch.cuda.empty_cache()
    return dict(loss_cpu=loss_cpu, loss_rel=abs(loss_card - loss_cpu) / abs(loss_cpu),
                loss_tol=SSL_LOSS_TOL, tf32_loss_rel=abs(loss_tf32 - loss_cpu) / abs(loss_cpu),
                param_share_off=off / total, param_share_tol=SSL_PARAM_SHARE,
                param_max_abs_diff=worst, update_max_abs=moved, lr=SSL_CMP_LR,
                seconds=time.perf_counter() - t)


def phase_ssl_pretrain(dev, card: str) -> dict:
    """The SSL pre-trainers at full width (module docstring, 14)."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.data.synthetic import SyntheticImages
    from sgdm_tpu_torch.device import no_tf32
    from sgdm_tpu_torch.models.vit import VisionTransformer
    from sgdm_tpu_torch.selfsup import eval_probes, mae, mae_finetune, mae_train, msn_train
    from sgdm_tpu_torch.selfsup import pretrain_common as pc
    from sgdm_tpu_torch.selfsup.ssl_backbone import get_ssl_backbone

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    row: dict = dict(card=card)
    constant_lr = pc.scale_by_schedule(lambda s: -SSL_CMP_LR)
    rng = np.random.default_rng(0)
    b_cpu = SSL_CPU_BATCH
    ma = mae_train.build_argparser().parse_args(list(SSL_MAE_ARGS))
    sa = msn_train.build_argparser().parse_args(list(SSL_MSN_ARGS))
    fa = mae_finetune.build_argparser().parse_args(list(SSL_FT_ARGS))
    torch.cuda.synchronize()
    ops.reset_launch_counts()

    def cli_argv(argv):
        return ["--device", "cuda", "--workers", str(SSL_WORKERS), "--log-every", "1000", *argv]

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)

    # 1. MAE pre-training through the CLI, ending in the encoder's export
    mae_rec: dict = {}
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    with patched(mae_train, "make_mae_train_step", ssl_timed(mae.make_mae_train_step, mae_rec)):
        mae_out = mae_train.main(cli_argv([*SSL_MAE_ARGS, "--batch-size", str(SSL_MAE_BATCH),
                                           "--data-len", str(SSL_MAE_BATCH * SSL_MAE_STEPS),
                                           "--out", str(root / "mae.msgpack")]))
    cli_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev)
    mae_model = mae_rec["args"][0]
    size = ma.input_size
    rate = ssl_dataset_rate(mae_train.AugmentedDataset(
        SyntheticImages(size=size, length=3 * SSL_MAE_BATCH), size), SSL_MAE_BATCH)
    row["mae"] = dict(ssl_step_row(mae_rec, SSL_MAE_BATCH, peak, rate), cli_s=cli_s)
    xm, nm = normal(b_cpu, 3, size, size), torch.rand(b_cpu, (size // ma.patch_size) ** 2)

    def mae_build():
        m = mae.MAE(ma.patch_size, ma.embed_dim, ma.depth, ma.num_heads, ma.decoder_dim,
                    ma.decoder_depth, ma.decoder_heads, ma.mask_ratio, size)
        return pc.flax_init_(m, torch.Generator().manual_seed(1))

    def mae_make(m):
        return mae.make_mae_train_step(m, pc.chain(
            pc.scale_by_adam(0.9, 0.95), pc.add_decayed_weights(0.05, mask=pc.wd_mask), constant_lr))

    def mae_step(model, step, d, loss_only=False):
        if loss_only:
            return mae.mae_loss(*model(xm.to(d), noise=nm.to(d)))
        return step(xm.to(d), noise=nm.to(d))

    row["mae"]["card_vs_cpu"] = ssl_card_vs_cpu(dev, mae_build, mae_make, mae_step)
    print(json.dumps({"ssl_mae": row["mae"]}), flush=True)

    # 2. the export read back as a backbone, against the trained encoder; the probes
    bb = get_ssl_backbone("mae_vitb16", image_size=size, ckpt_path=str(mae_out), device=dev)
    enc = VisionTransformer(ma.patch_size, ma.embed_dim, ma.depth, ma.num_heads,
                            pretrain_img_size=size).to(dev).eval()
    enc.load_state_dict(mae.encoder_state_for_backbone(mae_model.state_dict()))
    data = SyntheticImages(size=64, length=SSL_PROBE_ROWS)    # transform_batch resizes
    t = time.perf_counter()
    feats, labels = [], []
    for i in range(0, SSL_PROBE_ROWS, 256):
        items = data.get_batch(np.arange(i, min(i + 256, SSL_PROBE_ROWS)))
        x = bb.transform_batch(items["img4unsup"])
        feats.append(bb.batch_encode_feat(x))
        labels += items["label"].argmax(1).tolist()
        if i == 0:
            with torch.no_grad(), no_tf32():
                ref = enc(x[:SSL_MAE_BATCH]).cpu().numpy()
            feat_err = float(np.abs(ref - feats[0][:SSL_MAE_BATCH]).max())
    feats, labels = np.concatenate(feats), np.asarray(labels)
    encode_s = time.perf_counter() - t
    n_tr = SSL_PROBE_ROWS - SSL_PROBE_TEST
    split = (feats[:n_tr], labels[:n_tr], feats[n_tr:], labels[n_tr:])
    t = time.perf_counter()
    logistic = eval_probes.logistic_eval(*split, device=dev)
    logistic_s = time.perf_counter() - t
    t = time.perf_counter()
    linear = eval_probes.linear_probe(*split, epochs=10, device=dev)
    linear_s = time.perf_counter() - t
    row["export"] = dict(feat_max_abs_err=feat_err, tol=SSL_FEAT_TOL, rows=SSL_PROBE_ROWS,
                         encode_s=encode_s, images_per_s=SSL_PROBE_ROWS / encode_s,
                         logistic=dict(logistic, seconds=logistic_s),
                         linear=dict(linear, seconds=linear_s, epochs=10),
                         finite=bool(np.isfinite(feats).all()))
    print(json.dumps({"ssl_export": row["export"]}), flush=True)
    del bb, enc, mae_model, mae_rec
    torch.cuda.empty_cache()

    # 3. MSN through the CLI
    msn_rec: dict = {}
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    with patched(msn_train, "make_msn_full_train_step",
                 ssl_timed(msn_train.make_msn_full_train_step, msn_rec)):
        msn_out = msn_train.main(cli_argv([*SSL_MSN_ARGS, "--batch-size", str(SSL_MSN_BATCH),
                                           "--data-len", str(SSL_MSN_BATCH * SSL_MSN_STEPS),
                                           "--out", str(root / "msn.msgpack")]))
    cli_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev)
    views_kw = dict(rand_size=sa.rand_size, focal_size=sa.focal_size, rand_views=sa.rand_views,
                    focal_views=sa.focal_views)
    rate = ssl_dataset_rate(msn_train.MultiCropDataset(
        SyntheticImages(size=sa.rand_size, length=3 * SSL_MSN_BATCH), **views_kw), SSL_MSN_BATCH)
    row["msn"] = dict(ssl_step_row(msn_rec, SSL_MSN_BATCH, peak, rate), cli_s=cli_s)
    r, f, p = sa.rand_size, sa.focal_size, sa.patch_size
    views = {"target": normal(b_cpu, 3, r, r), "anchors": normal(b_cpu, sa.rand_views, 3, r, r),
             "focals": normal(b_cpu, sa.focal_views, 3, f, f)}
    ids = tuple(torch.as_tensor(np.argsort(rng.random((v * b_cpu, (s // p) ** 2)), 1)
                                [:, :max(int((s // p) ** 2 * (1 - sa.patch_drop)), 1)])
                for v, s in ((sa.rand_views, r), (sa.focal_views, f)))

    class MSNPair(torch.nn.Module):
        """Encoder, prototypes and target as one module (moved and compared together)."""

        def __init__(self):
            super().__init__()
            g = torch.Generator().manual_seed(2)
            self.enc = pc.flax_init_(VisionTransformer(p, sa.embed_dim, sa.depth, sa.num_heads,
                                                       pretrain_img_size=r), g)
            self.protos = torch.nn.Parameter(torch.randn(sa.num_proto, sa.embed_dim,
                                                         generator=g) * 0.025)
            self.target = VisionTransformer(p, sa.embed_dim, sa.depth, sa.num_heads,
                                            pretrain_img_size=r)
            self.target.load_state_dict(self.enc.state_dict())
            self.target.requires_grad_(False)

    def msn_make(m):
        mask = pc.wd_mask(list(m.enc.parameters())) + [False]
        tx = pc.chain(pc.clip_by_global_norm(sa.clip_grad), pc.scale_by_adam(),
                      pc.scheduled_weight_decay(sa.wd, sa.final_wd, 100, mask=mask), constant_lr)
        return msn_train.make_msn_full_train_step(m.enc, m.protos, m.target, tx,
                                                  patch_drop=sa.patch_drop, **views_kw)

    def msn_step(m, step, d, loss_only=False):
        b = {k: v.to(d) for k, v in views.items()}
        kept = tuple(i.to(d) for i in ids)
        if loss_only:
            emb = torch.cat([m.enc(msn_train._views_first(b["anchors"]), patch_keep_ids=kept[0]),
                             m.enc(msn_train._views_first(b["focals"]), patch_keep_ids=kept[1])])
            return msn_train.msn_multiview_loss(emb, m.target(b["target"]), m.protos,
                                                num_views=sa.rand_views + sa.focal_views)[0]
        return step(b, 0.996, 0.25, ids=kept)[0]

    row["msn"]["card_vs_cpu"] = ssl_card_vs_cpu(dev, MSNPair, msn_make, msn_step)
    print(json.dumps({"ssl_msn": row["msn"]}), flush=True)
    torch.cuda.empty_cache()

    # 4. MAE fine-tuning from the MAE export, through the CLI
    ft_rec: dict = {}
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    with patched(mae_finetune, "make_finetune_train_step",
                 ssl_timed(mae_finetune.make_finetune_train_step, ft_rec)):
        ft_out = mae_finetune.main(["--device", "cuda", "--workers", str(SSL_WORKERS),
                                    *SSL_FT_ARGS, "--finetune", str(mae_out),
                                    "--batch_size", str(SSL_FT_BATCH), "--epochs", "1",
                                    "--n_train", str(SSL_FT_BATCH * SSL_FT_STEPS),
                                    "--n_val", str(SSL_FT_BATCH),
                                    "--output_dir", str(root / "ft")])
    cli_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev)
    size = fa.input_size
    rate = ssl_dataset_rate(mae_finetune.FinetuneDataset(
        SyntheticImages(size=size, length=3 * SSL_FT_BATCH), size, train=True), SSL_FT_BATCH)
    row["finetune"] = dict(ssl_step_row(ft_rec, SSL_FT_BATCH, peak, rate), cli_s=cli_s)
    xf = normal(b_cpu, 3, size, size)
    yf = torch.as_tensor(rng.integers(0, fa.nb_classes, b_cpu))
    masks = torch.as_tensor((rng.random((fa.depth, 2, b_cpu)) < 0.9).astype(np.float32))
    draws = dict(lam_m=0.7, lam0=0.6, cy=0.4 * size, cx=0.2 * size, use_cut=True, applied=True)

    def ft_build():
        g = torch.Generator().manual_seed(3)
        m = mae_finetune.init_classifier_(mae_finetune.build_model(fa), g)
        with torch.no_grad():   # a head of N(0, 1/fan_in): logits, and so the loss, see the trunk
            m.head.weight.copy_(torch.randn(m.head.weight.shape, generator=g) / fa.embed_dim ** 0.5)
        return m

    def ft_make(m):
        tx = mae_finetune.make_finetune_tx(m, lambda s: SSL_CMP_LR, weight_decay=fa.weight_decay,
                                           layer_decay=fa.layer_decay, depth=fa.depth)
        return mae_finetune.make_finetune_train_step(m, tx, fa.nb_classes, mixup_alpha=fa.mixup,
                                                     cutmix_alpha=fa.cutmix,
                                                     smoothing=fa.smoothing)

    def ft_step(m, step, d, loss_only=False):
        dd = dict(draws, drop_masks=masks.to(d))
        if loss_only:
            x, tgt = mae_finetune.apply_mixup(xf.to(d), yf.to(d), fa.nb_classes, dd,
                                              mixup_alpha=fa.mixup, cutmix_alpha=fa.cutmix,
                                              smoothing=fa.smoothing)
            return mae_finetune.soft_target_ce(m(x, drop_masks=dd["drop_masks"]), tgt)
        return step(xf.to(d), yf.to(d), draws=dd)

    row["finetune"]["card_vs_cpu"] = ssl_card_vs_cpu(dev, ft_build, ft_make, ft_step)
    print(json.dumps({"ssl_finetune": row["finetune"]}), flush=True)

    torch.cuda.synchronize()
    counts = ops.launch_counts()
    files = {p.name: p.stat().st_size for p in (mae_out, msn_out, ft_out,
                                                 root / "ft" / "finetuned_encoder.msgpack")}
    tmp.cleanup()
    row.update(files=files, launches=counts, phase_seconds=time.perf_counter() - t_phase)
    print(json.dumps({"ssl_pretrain": {k: row[k] for k in ("card", "files", "launches",
                                                          "phase_seconds")}}), flush=True)
    for name in ("mae", "msn", "finetune"):
        c = row[name]["card_vs_cpu"]
        assert c["loss_rel"] <= SSL_LOSS_TOL < c["tf32_loss_rel"], (name, c)
        assert c["param_share_off"] <= SSL_PARAM_SHARE and c["update_max_abs"] > 0, (name, c)
        assert len(row[name]["ms_all"]) >= 2, (name, row[name])
    ex = row["export"]
    assert ex["finite"] and ex["feat_max_abs_err"] <= SSL_FEAT_TOL, ex
    assert 0.0 <= ex["logistic"]["test_score"] <= 1.0 and 0.0 <= ex["linear"]["test_score"] <= 1.0
    assert all(v > 0 for v in files.values()), files
    assert not any(counts.values()), counts
    return {"ssl_pretrain": counts}


# ---------------------------------------------------------------- phase 15

def phase_vis_voc64(dev, card: str) -> dict:
    """The VOC64 paper figures through the test phase (module docstring, 15)."""
    import shutil
    from pathlib import Path
    from unittest import mock

    import numpy as np
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.config.engine import instantiate_from_config, load_config, to_container
    from sgdm_tpu_torch.eval import harness
    from sgdm_tpu_torch.models.factory import init_random_params
    from sgdm_tpu_torch.training import trainer as trainer_mod
    from sgdm_tpu_torch.utils.logging import NullTracker
    from sgdm_tpu_torch.utils.png import read_png

    here = Path(__file__).resolve().parent
    root = here / "build" / "vis_voc64"
    shutil.rmtree(root, ignore_errors=True)
    (root / "ref").mkdir(parents=True)
    cfg = load_config(here / VOC_CONFIG, [
        f"log_dir={root / 'run'}", f"data.root={root}", f"sg.params.cond_dim={VIS_VOC_CLUSTERS}",
        "sg.params.cond_scale=2", f"model.params.num_timesteps_test={VIS_VOC_STEPS}"])
    ds = {"target": "sgdm_tpu.data.synthetic.SyntheticSegImages",
          "params": dict(size=64, num_classes=20, length=2 * VIS_VOC_N, seed=0, cond_key="label",
                         stego_k=21, cluster_k=VIS_VOC_CLUSTERS)}
    data_cfg = dict(to_container(cfg.data), target="sgdm_tpu.data.datamodule.DataModuleFromConfig",
                    params=dict(batch_size=VIS_VOC_N, num_workers=4, train=ds, validation=ds),
                    fid_train_image_dir=str(root / "ref"), fid_val_image_dir=None,
                    test_fid_num=VIS_VOC_N)
    sg_params = dict(to_container(cfg.sg.params), pl=to_container(cfg.pl), data=data_cfg,
                     wandb={}, seed=23)
    with mock.patch.object(trainer_mod, "init_train_params", init_random_params):
        trainer = instantiate_from_config({"target": cfg.sg.target, "params": sg_params},
                                          device=dev)
        trainer.tracker = NullTracker()
        trainer.datamodule = instantiate_from_config(data_cfg)
        trainer._init_state()
    test_cfg = dict(to_container(cfg), data=data_cfg, exp={"cond_scale": True}, debug=False,
                    vis={k: True for k in VIS_VOC})
    figure_s: dict = {}
    # the FIDs stubbed: phase fid measures them, here they would be the
    # host's sqrtm
    with mock.patch.object(harness, "get_fid_dict", lambda *a, **k: ({}, float("nan"))), \
            mock.patch.object(harness, "_extractor", lambda device: None), \
            timed_figures(figure_s):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        harness.run_test_and_all_exploration(trainer, test_cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
    # the scale list [2, 0], a batch each, then the chain at scale 2
    forwards = 3 * VIS_VOC_STEPS
    want = dict({k: 0 for k in META}, **{k: v * forwards for k, v in CA_SAMPLE_LAUNCHES.items()})
    shapes = png_shapes(root / "run" / "papervis")
    red = {n: int((read_png(root / "run" / "papervis" / n) == [255, 0, 0]).all(-1).sum())
           for n in shapes if "lost" in n}
    print(json.dumps({"vis_voc64": dict(card=card, samples=VIS_VOC_N, steps=VIS_VOC_STEPS,
                                        seconds=seconds, figures=shapes, red_box_pixels=red,
                                        figure_seconds=figure_s, launches=counts)}), flush=True)
    assert counts == want, f"vis_voc64: launch counts {counts} != {want}"
    tile = lambda n, ncol, px, pad: [-(-n // ncol) * (px + pad) - pad, ncol * (px + pad) - pad, 3]
    # (overlay, sample) pairs of the first 32, 4 pairs a row; the first 64 boxed, 8 a row
    assert shapes["clusterlayout_random_stego_with_mask_0.png"] == \
        tile(2 * min(32, VIS_VOC_N), 8, 256, 5), shapes
    assert shapes["clusterlayout_random_lost_with_box_0.png"] == \
        tile(min(64, VIS_VOC_N), 8, 256, 5), shapes
    for name in ("stego_chainvis.png", "lost_chainvis.png"):
        h, w, _ = shapes[name]
        assert h == tile(min(7, VIS_VOC_N), 1, 64, 2)[0] and (w + 2) % 66 == 0 and w > 66, \
            (name, shapes[name])
    assert all(v > 0 for v in red.values()) and len(red) == 2, red   # the LOST boxes drawn
    shutil.rmtree(root, ignore_errors=True)
    return {"vis_voc64": counts}


# ---------------------------------------------------------------- phase 16

def phase_zoo(dev, card: str) -> dict:
    """The Imagen / LDM-codec / VQ zoo (module docstring, 16)."""
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.models import codec, vq, zoo_imagen

    rel = lambda a, b: float((a.float().cpu() - b.float()).abs().max() / b.float().abs().max())
    ops.reset_launch_counts()
    out: dict = {"card": card}
    with full_f32(), torch.no_grad():
        # BaseUnet64 at its preset, seeded weights built on the card
        torch.manual_seed(0)
        with torch.device(dev):
            unet = zoo_imagen.BaseUnet64(max_text_len=ZOO_TEXT[0], text_embed_dim=ZOO_TEXT[1])
        unet.eval()
        n_params = sum(p.numel() for p in unet.parameters())
        gen = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(2, 64, 64, 3, generator=gen, device=dev)
        t = torch.rand(2, generator=gen, device=dev)
        text = torch.randn(2, *ZOO_TEXT, generator=gen, device=dev)
        cfg_ms = cuda_time(lambda: unet.forward_with_cond_scale(x, t, 3.0, text), iters=3,
                           warmup=1)
        eps = unet.forward_with_cond_scale(x, t, 3.0, text)
        one_ms = cuda_time(lambda: unet(x[:1], t[:1], cond=text[:1]), iters=3, warmup=1)
        card1 = unet(x[:1], t[:1], cond=text[:1])
        peak = torch.cuda.max_memory_allocated(dev)
        with torch.device("meta"):
            cpu = zoo_imagen.BaseUnet64(max_text_len=ZOO_TEXT[0], text_embed_dim=ZOO_TEXT[1])
        cpu = cpu.to_empty(device="cpu")
        cpu.load_state_dict(unet.state_dict())
        t0 = time.perf_counter()
        ref1 = cpu(x[:1].cpu(), t[:1].cpu(), cond=text[:1].cpu())
        cpu_s = time.perf_counter() - t0
        del cpu, unet
        torch.cuda.empty_cache()
        out["imagen"] = dict(params=n_params, param_bytes_f32=4 * n_params,
                             cfg_batch=4, forward_with_cond_scale_ms_batch2=cfg_ms,
                             forward_ms_batch1=one_ms, card_vs_cpu_rel=rel(card1, ref1),
                             cpu_forward_s=cpu_s, peak_bytes=peak,
                             finite=bool(torch.isfinite(eps).all()))

        # the LDM kl-f8 first stage at 256 px
        ks = dict(ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, attn_resolutions=(),
                  resolution=256)
        torch.manual_seed(2)
        enc, dec = codec.Encoder(z_channels=4, double_z=True, **ks), \
            codec.Decoder(out_ch=3, z_channels=4, **ks)
        enc_cpu, dec_cpu = enc.eval(), dec.eval()
        enc_dev = codec.Encoder(z_channels=4, double_z=True, **ks).to(dev).eval()
        dec_dev = codec.Decoder(out_ch=3, z_channels=4, **ks).to(dev).eval()
        enc_dev.load_state_dict(enc_cpu.state_dict())
        dec_dev.load_state_dict(dec_cpu.state_dict())
        img = torch.rand(4, 256, 256, 3, generator=gen, device=dev) * 2 - 1
        enc_ms = cuda_time(lambda: enc_dev(img), iters=3, warmup=1)
        moments = enc_dev(img)
        z = moments[..., :4]
        dec_ms = cuda_time(lambda: dec_dev(z), iters=3, warmup=1)
        rec = dec_dev(z)
        ref_m = enc_cpu(img[:1].cpu())
        ref_r = dec_cpu(ref_m[..., :4])
        out["ldm_kl_f8"] = dict(batch=4, encode_ms=enc_ms, decode_ms=dec_ms,
                                latent=list(moments.shape), image=list(rec.shape),
                                encode_rel=rel(moments[:1], ref_m), decode_rel=rel(rec[:1], ref_r),
                                params=sum(p.numel() for p in enc_dev.parameters())
                                + sum(p.numel() for p in dec_dev.parameters()))
        del enc_dev, dec_dev

    # VectorQuantize(256, 512): EMA train steps on the card and on the CPU
    torch.manual_seed(3)
    q_dev, q_cpu = vq.VectorQuantize(256, 512).to(dev), vq.VectorQuantize(256, 512)
    xs = [torch.randn(*ZOO_VQ_SHAPE, generator=torch.Generator().manual_seed(10 + i))
          for i in range(ZOO_VQ_STEPS)]
    with full_f32():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for xv in xs:
            qd, ind_d, loss_d = q_dev(xv.to(dev), train=True)
        end.record()
        torch.cuda.synchronize()
        for xv in xs:
            qc, ind_c, loss_c = q_cpu(xv, train=True)
    out["vq"] = dict(shape=list(ZOO_VQ_SHAPE), steps=ZOO_VQ_STEPS,
                     ms_per_step=start.elapsed_time(end) / ZOO_VQ_STEPS,
                     index_agreement=float((ind_d.cpu() == ind_c).float().mean()),
                     **{f"{k}_rel": rel(getattr(q_dev, k), getattr(q_cpu, k))
                        for k in ("embed", "embed_avg", "cluster_size")},
                     loss_rel=abs(float(loss_d) - float(loss_c)) / float(loss_c))
    counts = ops.launch_counts()
    print(json.dumps({"zoo": dict(out, launches=counts)}), flush=True)
    im, ldm, vqr = out["imagen"], out["ldm_kl_f8"], out["vq"]
    assert im["finite"] and im["card_vs_cpu_rel"] <= ZOO_TOL, im
    assert ldm["encode_rel"] <= ZOO_TOL and ldm["decode_rel"] <= ZOO_TOL, ldm
    assert ldm["latent"] == [4, 32, 32, 8] and ldm["image"] == [4, 256, 256, 3], ldm
    assert vqr["index_agreement"] >= 0.999 and max(
        vqr[f"{k}_rel"] for k in ("embed", "embed_avg", "cluster_size")) <= ZOO_TOL, vqr
    assert not any(counts.values()), counts      # no TPU kernel on this path
    return {"zoo": counts}


# ---------------------------------------------------------------- phase 17

def write_wrn_pickles(root, seed: int = 0) -> None:
    """10 train pickles of WRN_PER_FILE 64-px rows (uint8 CHW, labels
    1..1000, the file's mean image) and a val pickle of WRN_VAL rows."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(seed)
    row = 3 * 64 * 64
    root.mkdir(parents=True)
    for i in range(1, 11):
        data = rng.integers(0, 256, (WRN_PER_FILE, row), np.uint8)
        with open(root / f"train_data_batch_{i}", "wb") as f:
            pickle.dump({"data": data, "labels": rng.integers(1, 1001, WRN_PER_FILE).tolist(),
                         "mean": data.mean(0)}, f, protocol=4)
    with open(root / "val_data", "wb") as f:
        pickle.dump({"data": rng.integers(0, 256, (WRN_VAL, row), np.uint8),
                     "labels": rng.integers(1, 1001, WRN_VAL).tolist()}, f, protocol=4)


def phase_wrn(dev, card: str) -> dict:
    """The WRN validator's CLI at its defaults on 64 px (module docstring, 17)."""
    import copy
    import functools
    import pickle
    import shutil
    from pathlib import Path
    from unittest import mock

    import numpy as np
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.data import wrn_validate as wrn

    root = Path(__file__).resolve().parent / "build" / "wrn"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_wrn_pickles(root / "data")
    write_s = time.perf_counter() - t0

    # one step on the card against the same step on the CPU
    model = wrn.WideResNet(img_size=64, seed=5)
    card_model = copy.deepcopy(model).to(dev)
    d = wrn.load_databatch(root / "data", 1, 64)
    xb = torch.as_tensor(d["X"][:WRN_CPU_BATCH])
    yb = torch.as_tensor(d["Y"][:WRN_CPU_BATCH])
    with full_f32():
        steps = {}
        for name, m, where in (("cpu", model, "cpu"), ("card", card_model, dev)):
            vel = {k: torch.zeros_like(p) for k, p in m.named_parameters()}
            step, _ = wrn.make_wrn_steps(m, 5e-4)
            steps[name] = float(step(vel, xb.to(where), yb.to(where), 0.01))
    # the update card vs CPU: ‖Δcard − Δcpu‖ / ‖Δcpu‖ over every parameter but
    # the conv2 biases (each reaches the loss only through the next
    # BatchNorm, which takes away a per-channel constant: its gradient is 0
    # in exact arithmetic, its update rounding noise on both sides); the
    # leaf with the largest such ratio is printed beside it
    start = wrn.WideResNet(img_size=64, seed=5).state_dict()
    sd_c, sd_d = model.state_dict(), card_model.state_dict()
    keys = [k for k, _ in model.named_parameters() if not k.endswith("conv2.bias")]
    d_c = {k: sd_c[k] - start[k] for k in keys}
    d_d = {k: sd_d[k].cpu() - start[k] for k in keys}
    num = math.sqrt(sum(float((d_d[k] - d_c[k]).square().sum()) for k in keys))
    den = math.sqrt(sum(float(d_c[k].square().sum()) for k in keys))
    worst = num / den
    leaf = max(keys, key=lambda k: float((d_d[k] - d_c[k]).norm() / d_c[k].norm().clamp_min(1e-30)))
    leaf_err = float((d_d[leaf] - d_c[leaf]).norm() / d_c[leaf].norm().clamp_min(1e-30))

    recs = []
    real = wrn.train_wrn
    ops.reset_launch_counts()
    with mock.patch.object(wrn, "train_wrn", functools.partial(real, report=recs.append)):
        t0 = time.perf_counter()
        first = wrn.main(["-df", str(root / "data"), "-s", "64", "-e", "1",
                          "--ckpt", str(root / "wrn_last.p")])
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        second = wrn.main(["-df", str(root / "data"), "-s", "64", "-e", "2", "-c",
                           str(root / "wrn_last.p"), "--ckpt", str(root / "wrn_resumed.p")])
        second_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    with open(root / "wrn_resumed.p", "rb") as f:
        epoch = pickle.load(f)["epoch"]
    step_s = [s for r in recs for s in r["step_seconds"][5:]]
    row = dict(card=card, pickles_s=write_s, steps_per_epoch=[len(r["step_seconds"]) for r in recs],
               ms_per_step_median=float(np.median(step_s)) * 1e3,
               ms_per_step_mean=float(np.mean(step_s)) * 1e3, epoch_s=[first_s, second_s],
               epochs=[r["epoch"] for r in recs], lr=[r["lr"] for r in recs],
               val_loss=[r["val_loss"] for r in recs], top1=[r["top1"] for r in recs],
               final=dict(loss=first["loss"], top1=first["top1"], top5=first["top5"]),
               resumed=dict(loss=second["loss"], top1=second["top1"], top5=second["top5"]),
               resumed_epoch=epoch, step_loss_card=steps["card"], step_loss_cpu=steps["cpu"],
               card_vs_cpu_update_rel=worst, worst_leaf=leaf, worst_leaf_rel=leaf_err,
               launches=counts)
    print(json.dumps({"wrn": row}), flush=True)
    assert row["epochs"] == [1, 2] and epoch == 2, row
    assert row["steps_per_epoch"] == [2 * WRN_PER_FILE // 128 * 10] * 2, row
    assert all(math.isfinite(v) for v in row["val_loss"] + [second["loss"]]), row
    assert worst <= WRN_UPDATE_TOL, row
    assert abs(steps["card"] - steps["cpu"]) <= WRN_LOSS_TOL * steps["cpu"], row
    assert not any(counts.values()), counts
    shutil.rmtree(root, ignore_errors=True)
    return {"wrn": counts}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="build,kernels,forward,sample,samplers,train,forward_ca,"
                                        "sample_ca,train_ca,forward_b,fit,fit_in64p,images,"
                                        "feat_in64p,cluster_in64p,cluster_pca_in64p,"
                                        "lost_voc64,stego_coco64,backbones,"
                                        "fit_voc64_lost,fit_coco64_stego,fid,parallel,"
                                        "classifier,data7c,vdiff,ssl_pretrain,vis_voc64,"
                                        "zoo,wrn")
    ap.add_argument("--quick", action="store_true", help="fewer timing iterations")
    ap.add_argument("--kernels", default=None,
                    help="kernels phase: only these of resblock (K1, K2, K4, K5 and their odd "
                         "shapes),null_kv_attention,groupnorm_silu,self_attention,"
                         "flash_attention")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    t_script = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from sgdm_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(f"card: {smi}; torch {torch.__version__}; CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s {built}", flush=True)
    if args.quick:
        for log in sorted(build._build_dir().glob("*.log")):
            print(log.read_text()[-4000:])

    only = set(args.kernels.split(",")) if args.kernels else None
    took: dict[str, float] = {"build": time.perf_counter() - t_script}

    @contextlib.contextmanager
    def clock(name: str):
        """Adds the block's wall seconds to ``took[name]`` and prints them."""
        t = time.perf_counter()
        try:
            yield
        finally:
            took[name] = took.get(name, 0.0) + time.perf_counter() - t
            print(json.dumps({"phase_done": {name: took[name]}}), flush=True)

    agg = {}
    if "kernels" in phases:
        with clock("kernels"):
            agg = phase_kernels(dev, 3 if args.quick else KERNEL_ITERS, only)
    # launches by path: every path is driven with the counters set to 0 just
    # before and read just after
    paths = {}
    if phases & {"forward", "sample", "samplers", "profile"}:
        cfg, model = build_model(dev)
        if "forward" in phases:
            with clock("forward"):
                phase_forward(dev, model)
        if "sample" in phases:
            with clock("sample"):
                paths["sample"] = phase_sample(dev, cfg, model, smi)
                roofline_sample(smi)
        if "samplers" in phases:
            with clock("samplers"):
                paths.update(phase_samplers(dev, cfg, model, smi))
        if "profile" in phases:
            phase_profile(dev, cfg, model)
            phase_profile_attention_block(dev)
        del model
    if "train" in phases:
        with clock("train"):
            paths["train"] = phase_train(dev, smi, agg=agg)
    if "profile" in phases:
        phase_profile_train(dev)
        phase_profile_attention_block_train(dev)
    if phases & {"forward_ca", "sample_ca", "samplers", "profile"}:
        cfg, model = build_model_ca(dev)
        if "forward_ca" in phases:
            with clock("forward_ca"):
                phase_forward_ca(dev, model)
        if "sample_ca" in phases:
            with clock("sample_ca"):
                paths["sample_ca"] = phase_sample_ca(dev, cfg, model, smi)
        if "samplers" in phases:
            with clock("samplers"):
                paths["samplers_mask_dir"] = phase_mask_dir(dev, cfg, model, smi)
        if "profile" in phases:
            gen = torch.Generator(device=dev)
            gen.manual_seed(2)
            phase_profile(dev, cfg, model, tag="profile_ca",
                          layout=layout_ids(gen, dev, SAMPLE_N))
        del model
    if "train_ca" in phases:
        with clock("train_ca"):
            paths["train_ca"] = phase_train(dev, smi, "unetca")
    if "profile" in phases:
        phase_profile_train(dev, family="unetca")
    if "forward_b" in phases:
        with clock("forward_b"):
            paths["sample_b"] = phase_forward_b(dev, smi)
    if "fit" in phases:
        torch.empty(0, device=dev)  # the context exists before its statistics are reset
        torch.cuda.reset_peak_memory_stats(dev)
        with clock("fit"):
            paths.update(phase_fit(dev, smi))
    if "fit_in64p" in phases:
        with clock("fit_in64p"):
            paths.update(phase_fit_in64p(dev, smi))
            runbook_check(dev, smi)
    if "images" in phases:
        with clock("images"):
            phase_images(smi)
    if phases & {"feat_in64p", "cluster_in64p", "cluster_pca_in64p"}:
        with clock("feat_in64p"):
            counts, feat_h5 = phase_feat_in64p(dev, smi)  # the cluster phases read its file
        if "feat_in64p" in phases:
            paths.update(counts)
        if "cluster_pca_in64p" in phases:
            with clock("cluster_pca_in64p"):
                paths.update(phase_cluster_pca_in64p(dev, smi, feat_h5))
        if "cluster_in64p" in phases:       # last: it removes the feat tree
            with clock("cluster_in64p"):
                paths.update(phase_cluster_in64p(dev, smi, feat_h5))
    for name, fn in (("lost_voc64", phase_lost_voc64), ("stego_coco64", phase_stego_coco64),
                     ("backbones", phase_backbones)):
        if name in phases:
            with clock(name):
                paths.update(fn(dev, smi))
    for run in ("fit_voc64_lost", "fit_coco64_stego"):
        if run in phases:
            with clock(run):
                paths.update(phase_fit_seg(dev, smi, run))
    cli = None
    if {"fid", "parallel"} <= phases:
        # phase parallel's CLI runs beside phase fid, most of whose time is
        # the host's sqrtm
        torch.cuda.empty_cache()
        cli = parallel_cli_start()
    fid_cli = None
    if "fid" in phases:
        with clock("fid"):
            counts, fid_cli = phase_fid(dev, smi)   # its fid_cli runs on beside parallel
            paths.update(counts)
    if "parallel" in phases:
        with clock("parallel"):
            paths.update(phase_parallel(dev, smi, cli))
    if fid_cli is not None:
        with clock("fid"):
            fid_cli_finish(fid_cli)
    if "classifier" in phases:
        with clock("classifier"):
            paths.update(phase_classifier(dev, smi))
    if "data7c" in phases:
        with clock("data7c"):
            phase_data7c(smi, phase_train.s_per_step.get(""))
    if "vdiff" in phases:
        with clock("vdiff"):
            paths.update(phase_vdiff(dev, smi))
    if "ssl_pretrain" in phases:
        with clock("ssl_pretrain"):
            paths.update(phase_ssl_pretrain(dev, smi))
    for name, fn in (("vis_voc64", phase_vis_voc64), ("zoo", phase_zoo), ("wrn", phase_wrn)):
        if name in phases:
            with clock(name):
                paths.update(fn(dev, smi))
    if "profile" in phases:
        cfg, model = build_model_b(dev)
        phase_profile(dev, cfg, model, tag="profile_b", named=K6_KERNELS)
        del model

    # `launches`: the count on the main path of the slice that ported the
    # kernel (K1-K3: the IN64 sample; K4/K5/K8/K9: the IN64 train run; K7: the
    # VOC64 sample; K6: the unfused model's sample), null when that phase was
    # not asked for; `launches_by_path` has every path that was driven
    own = dict({k: "sample" for k in ("resblock", "resblock_resample", "self_attention")},
               **{k: "train" for k in TRAIN_LAUNCHES},
               null_kv_attention="sample_ca", groupnorm_silu="sample_b",
               flash_attention_fwd_f32="classifier", flash_attention_bwd_f32="classifier")
    rows = []
    for name, a in agg.items():
        by = max(a["by"], key=a["by"].get)
        rows.append({"name": name, "route": "cuda", "source": META[name][0],
                     "replaces": META[name][1],
                     "launches": paths.get(own[name], {}).get(name),
                     "launches_by_path": {p: c[name] for p, c in paths.items()},
                     "max_abs_err": a["err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
                     "bound_ms": a["bound_ms"], "bound_by": by, "library_ms": a["library_ms"],
                     **{k: a[k] for k in ("device_ms", "library_device_ms", "library_bwd_ms")
                        if k in a}})
    took.update({f"tooling_{k}": v for k, v in TOOLING_SECONDS.items()})
    print(json.dumps({"tooling_seconds": dict(TOOLING_SECONDS,
                                              total=sum(TOOLING_SECONDS.values()))}))
    print(json.dumps({"chip_smoke": dict(card=smi, phases=sorted(phases),
                                         seconds=time.perf_counter() - t_script,
                                         phase_seconds=took)}))
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
