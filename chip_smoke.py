"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phase traced]

`--phase traced` builds the kernels and runs the traced sync-free
decodes alone (phase_traced, below).

Builds the port's two CUDA kernels from their sources, with K2's
cycle-counting build (-DK2_CLOCKS), the three nvcc runs started together
(dcvc_tpu_torch/csrc/fused_dcb.cu, K1, and csrc/rans_decode.cu, K2;
sm_90a).  K1 is a chain of launches whose GEMMs
run on one wgmma/TMA core: it prints each kernel of K1's library with its
count of HGMMA (wgmma) and UTMALDG (TMA load) instructions from
`cuobjdump -sass`, and fails if a GEMM kernel has none or any HMMA
(mma.sync) is left.  Holds K1 against its plain PyTorch
version at the edge-case shapes of tests/test_fused_dcb.py, and K2 against
its plain version and the host decoder on the fixtures of
tests/test_device_decode.py / tests/test_pallas_decode.py (1/2/3/5/8
lanes, escapes, a count below the lane count and of 0, z -> y -> y
threading).  Checks the stages of the six full-width models (DMCI, HTS,
HTL, LD, DCVC-RT's intra and P models) in bf16 on the card against
float32 on the CPU, those of EVC, IntraNoAR, DCVC-FM, DCVC-HEM, DCVC-DC,
cheng2020, bmshj2018, DCVC-2021 and DCVC-TCM (float32) on the card
against the CPU at 256x256 (TCM's with no z symbol differing), and one
TINY
DMCI and one TINY HTS 2-chunk training step on the card against the same
steps on the CPU (float32, TF32 off).  Then it drives the
main path, one part at a time, each with the launch counts set to 0 just
before it and read just after, recording every K1 launch's shape and
every K2 launch's inputs:
  - DMCICodec (full published width, bf16, seeded random weights):
    compress -> bytes -> decompress on 1080p frames at two QPs and a 720p
    frame, and each stream decoded again on the device (device_ec, K2);
  - DMCI -> DMCHTCodec at HTS_CONFIG (init_scale 0.5): three 8-frame
    chunks at 1080p (memory reset on the second) and one at 720p, each
    decoded through the host coder and on the device;
  - DMCI -> DMCHTCodec at HTL_CONFIG (the ladder codec), the same chunks;
  - DMCI -> DMCLDCodec at LD_CONFIG (init_scale 0.5): 8 frames at 1080p
    (memory reset on the fifth) and 2 at 720p, decoded both ways; LD's K1
    launches per call and its shapes are derived from the model on the
    meta device (perf_probe.ld_stage_launches) and must match the card's;
  - DCVC-RT: RTIntraCodec at DMCIRTConfig() (the 368-channel trunk: K1's
    tail tiles) and DMCRTCodec at RT_CONFIG (init_scale 0.4), bf16, skip
    0.15, frames in [0, 1], the lanes pinned to 2 (force_ec): an intra
    frame (host decode) then 7 P frames at 1080p on shift_qp's banks
    (32, 40, 36) and an intra frame and 2 P frames at 720p (the odd 45x80
    grid), each P stream decoded by the host coder and by K2 (3 calls per
    frame); RT's K1 launches and shapes are derived from the models on
    the meta device (perf_probe.rt_stage_launches: 42 / 32 per intra
    encode / decode, and one of K1's two-plane form per two-way DCB of
    the P model, 37 per encode and 28 per decode) and must match the
    card's;
  - the legacy intra codecs (float32, RGB in [0, 1]): EVCCodec at
    EVC_CONFIG and IntraNoARCodec at INTRA_NOAR_CONFIG at 1080p and 720p,
    the scalable EVC (SCALABLE_EVC_CONFIG) and FM's IntraNoAR (N 256) at
    720p, each at q_scale 0.8 and 1.4 (seeded random weights at
    init_scale 0.4, lifted so that symbols are coded:
    perf_probe.lifted_legacy_intra): the bytes written and decoded back
    bit-exact, two encodes equal, the warm 1080p encode and decode timed;
    float32, no K1Block: no launch (NO_LAUNCHES at every counted call, as
    in each legacy part below);
  - DCVC-FM (float32, RGB in [0, 1]): DMCFMCodec at FM_CONFIG with
    seeded weights at init_scale 0.4, lifted so that y, mv and z symbols
    are coded (perf_probe.lifted_fm), its DPB seeded by the IntraNoAR
    codec of the part before: 3 P frames at 1080p and 2 at 720p, fa_idx
    from INDEX_MAP_FM, at q_index 12 and 51, each sequence encoded twice
    (the same bytes) and decoded bit-exact with equal final DPBs, the warm
    1080p P frame timed; float32, no K1Block: no launch;
  - DCVC-HEM and DCVC-DC (float32, RGB in [0, 1]): DMCHEMCodec at
    HEM_CONFIG and DMCDCCodec at DC_CONFIG, lifted as FM's
    (perf_probe.lifted_hem, lifted_dc), the same cases, q indexes and
    checks as DCVC-FM's part (HEM at the q scales of the family runner's
    ladders, DC's fa_idx from INDEX_MAP_DC); float32, no K1Block: no
    launch;
  - the CompressAI intra codecs and DCVC-2021 (float32, RGB in [0, 1],
    seeded weights lifted so that symbols are coded:
    perf_probe.lifted_compressai, lifted_dcvc): Cheng2020Codec at
    CHENG2020_Q1_3 and HyperpriorCodec at BMSHJ2018_Q1_5 code a 1080p
    image each, DCVCCodec at DCVC_CONFIG 2 P frames at 1080p from
    cheng2020's reconstruction, each decoded bit-exact (the final
    reference frame too); each call's wall time split into the host AR
    loop (with its us per latent position), the host rANS coder and the
    rest (HostClock); float32, no K1Block: no launch;
  - DCVC-TCM (float32, TF32 off, RGB in [0, 1], seeded weights lifted so
    that symbols are coded: perf_probe.lifted_tcm): DMCTCMCodec at
    TCM_CONFIG, its DPB seeded by the bmshj2018 codec's reconstruction: 3
    P frames at 1080p and 2 at 720p, encoded twice (the same bytes) and
    decoded bit-exact with equal final DPBs (frame and feature), the warm
    1080p P frame timed and split into the host rANS coder and the rest;
    float32, no K1Block: no launch;
  - training (perf_probe.TRAIN_CELLS): steps of the full-width trainers,
    float32, TF32 off: DMCI at batch 4 on 256x256 patches, LD at its
    stage0 shape (1 + 1 frames, batch 4), HTS at its stage1 shape (1 + 8
    + 8 frames, cascaded, rematerialised, batch 2) and HTL at 1 + 8
    frames (batch 2); ms per step, peak memory, losses and grad norms
    printed; every loss finite, no step skipped, the parameters moved.
    The training forwards run the plain DepthConvBlock (K1 has no
    backward, as the TPU kernel has none): this part launches no kernel;
  - the trainers into the codecs: image_main and video_main
    --model_structure ld run 2 steps each on synthetic PNG folders
    written into the checkout (video_main from damped random
    checkpoints, none of its steps skipped); their ckpt.pth.tar files
    load into
    DMCICodec and DMCLDCodec, which code a 720p frame bit-exact (encoder,
    host decode, K2 decode);
  - the evaluation entry: dcvc_tpu_torch.eval.video_main.main in-process
    on a seeded 1080p YUV420 file written into a temporary directory of
    the checkout (LD, HTS, and LD at two rates), then one point again
    with fresh codecs (the same .bin) and with device_ec (the same bits
    and PSNRs per frame), and LD on a seeded sequence of 3 1080p PNGs
    read and written without PIL (--save_decoded_frame: the decoded PNGs
    give the harness's PSNRs); and dcvc_tpu_torch.eval.family_main --model
    rt in float32 (the reference's type; every DCB plain, so no K1) on a
    seeded 1080p YUV420 file of 6 frames (gop 4, 2 rates), twice with
    fresh codecs: every frame bit-exact, the same .bin bytes; and
    family_main --model fm (float32, init_scale 0.4) on a seeded 720p
    YUV420 file of 6 frames the same way, then once with --fast (the
    estimated-bits mode: finite bpp and PSNRs, frame types I P P P I P);
    family_main --model hem and --model dc on a seeded 720p file of 4
    frames (gop 4, 2 rates: one container file per frame, every frame
    bit-exact), then --model hem --fast; family_main --model dcvc
    (cheng2020 + DCVC, the JAX runner's init) on a seeded 720p file of 4
    frames (gop 4, one rate), then --fast; family_main --model tcm
    (bmshj2018 + TCM, the JAX runner's init) on a seeded 720p file of 4
    frames (gop 4, one rate), then --fast, then with --model_path_p on the
    runner's own P model written as a reference .pth.tar by
    save_reference and converted to params.v1 by utils/import_cli.py (the
    same .bin bytes and numbers).
  - the evaluation surface, each part timed: params.v1 (the float32
    DMCI and HTS models written by save_native, read by load_native_into,
    their codecs coding a 1080p frame and a chunk to the in-memory
    codecs' bytes and DPB); the image CLI (image_main on three seeded
    PNGs, 1920x1080, 1280x720 and 768x512, host and device decodes, then
    --i_frame_model evc, intra_noar, cheng2020 and bmshj2018 on params.v1
    files of the legacy parts' weights; every image bit-exact); the workers (video_main
    --worker 2, two spawned processes on the one card, against --worker
    1: the same .bin bytes
    and numbers; the pool's launches are its processes' and not counted
    here); the BD gate (bd_gate, random full-width weights,
    --allow_extrapolation, 4 rates on a 256x384 sequence of GATE_FRAMES
    frames: strict finite JSON, RD points printed as pipeline
    validation); card vs CPU symbols (DMCI in float32 on a 256x256 frame
    at qp 8 and 32, collect_symbols on both: the share of differing z / y
    / idx symbols printed, a measurement; the card's round trip
    bit-exact).  Their K2 calls are counted, not replayed.  Then each
    full-width model's kMACs per pixel at 1080p (FlopCounterMode on the
    meta device).
  - the spatial split of DMCI (parallel/spatial.py): DMCICodec with
    spatial_devices=[cuda:0] * tiles at DMCIConfig(), bf16, the DMCI
    part's weights, on a 1080p and a 2160p frame at qp 0 and 32 in 2
    tiles and a 1080p frame at qp 32 in 4: encode -> host decode and K2
    decode bit-exact, two encodes equal, the split stream decoded by the
    unsplit codec and the unsplit one by the split codec with the
    decoders' symbols the encoders', K1 launches per call as derived on
    the meta device for the tile shapes (perf_probe.spatial_dmci_launches),
    warm wall ms split and unsplit;
  - the training surface of PR 16 (f32, no kernel): the data scripts
    (yuv_to_png on a seeded 1080p YUV420 file of 2 frames, make_synth's
    corpus; their PNGs read back), the trainers' CLIs as rank 0 of a
    one-rank NCCL job (WORLD_SIZE=1) on that corpus, one DMCI and one LD
    step with the NCCL all-reduce against the plain step (bit-exact, ms
    per step), dryrun_multichip(2) on cuda:0 over gloo against one
    process (smooth pictures and uniform noise); a JAX-layout status at
    DMCIConfig() written and resumed (the next step bit-exact with the
    uninterrupted run's), status_to_ckpt's params.v1 coding a 720p frame
    to the same bytes; EVC_LL mask decay (exact folds on the card, gates
    decaying, ms per step);
  - the pipelined calls (phase_pipeline; perf_probe's
    pipeline_cases and time_pipeline) on the main path's codecs at
    1080p, qp 32: DMCI compress_many over 8 images and decompress_many
    through the host coder and K2, RT intra's over 4, HTS
    compress_sequence / decompress_sequence (host coder and K2) over a
    DMCI frame + 6 chunks of 8 frames, HTL over 3 chunks and LD over 8
    frames, a reset in each: every run the serial calls' bytes, frames
    and final DPB bit for bit, every compress_async and every K2 decode
    under torch.cuda.set_sync_debug_mode("error"), K1 and K2 launched as
    derived per unit; the warm walls per unit, serial and pipelined, and
    each form's idle share (torch.profiler) printed.  Its K2 calls are
    counted, not replayed;
  - the sync-free device decodes traced (phase_traced): DMCI
    compress_many / decompress_many over 2 1080p images and HTS
    compress_sequence / decompress_sequence over 2 chunks, qp 32, inside a
    torch.profiler window with the program's recorder on
    (utils/profiling.py), every compress_async and every K2 decode under
    torch.cuda.set_sync_debug_mode("error"), the decoded frames and final
    DPB the encoder's bit for bit; the window must record every codec span
    name and the symbol counter, each span a FUNCTION-scope host event,
    and no device event may bear a span's name;
  - the envelope's K2 (phase_envelope_k2): an HTS chunk at 240p and at
    2160p from a DMCI frame, encoded and decoded on the card, its K2
    calls recorded for the replay;
  - the speed and conformance entry points (phase_entry_points): python3
    -m dcvc_tpu_torch.bench in its own process at bench.py's protocol
    (its JSON line, value > 0); eval/bench_variants.py for DMCI, HTL and
    HTS at 1080p with the host coder and with device_ec, HTS at 240p,
    480p and 2160p and DMCI at 240p, in this process on frames made on
    the card, each JSON line printed, its K1 / K2 launches as derived
    from the models (perf_probe.uf_call_launches), its zero-symbol
    decode chains run with host syncs an error; eval/compress_time.py
    (LD) on a synthetic 1080p HEVC_B sequence; eval/cross_platform run
    (both same-platform legs identical, the card <-> CPU legs printed);
    utils/download_checkpoints --import_native on a reference file it
    synthesises, no network touched.  Its K2 calls are counted, not
    replayed.
Before the main path, parallel/dryrun.entry() (the DMCI forward at
256x256 in bf16) runs once and is timed.
Every device decode of the parts before the evaluation entry runs under
torch.cuda.set_sync_debug_mode("error") once its lanes are uploaded: a
host sync fails it.  Last, both forms of K1 are held against their plain
versions and timed at every distinct shape the main path launched them
at (and, at the three heaviest, each launch of the chain is timed by
torch.profiler), and every K2 call of those parts is replayed
against its plain version and through its cycle-counting build, and
timed (the evaluation entry's K2 calls are counted, not replayed).
It fails, with a non-zero exit code, if the card is missing, a kernel does
not build or launch or disagrees with its plain version, the main path did
not launch the kernels as often as derived, a reconstruction or final DPB
is not bit-exact between encoder, host-coder decode and device decode, a
training step on the card disagrees with the CPU's, a full-width step's
loss is not finite or its step was skipped, a
device decode syncs with the host, two encodes give different streams,
or a point of the evaluation entry is incomplete, not finite or not
reproducible, or a part of the evaluation surface is not bit-exact or
differs from its serial / in-memory counterpart.

Output: one line per phase (K2's: a JSON line of its time, ns per symbol
per lane, cycles per symbol and latency bound per main-path label, with
the SM clock under load); then a JSON line with the kernel table; the
card's name and power limit; the smoke's total seconds; and last
{"ok": true, "device": {...}}.
"""

import collections
import concurrent.futures
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dcvc_tpu_torch.eval import bd_gate, bench_variants, compress_time, \
    cross_platform, family, family_main, image_main, video_main
from dcvc_tpu_torch.eval.harness import run_one_point_with_stream
from dcvc_tpu_torch.kernels import fused_dcb as K1
from dcvc_tpu_torch.kernels import rans_decode as K2
from dcvc_tpu_torch.models.common import draw_noise, get_training_lambdas
from dcvc_tpu_torch.models.dmc_ht import DMCHT, DMCHTConfig, HTL_CONFIG, \
    HTS_CONFIG, TINY_HT_CONFIG
from dcvc_tpu_torch.models.dmc_ld import DMCLD, LD_CONFIG
from dcvc_tpu_torch.models.dmci import DMCI, DMCIConfig, TINY_CONFIG
from dcvc_tpu_torch.kernels._build import library_path
from dcvc_tpu_torch.legacy.dcvc_rt import DMCRTCodec, INDEX_MAP, RT_CONFIG, \
    shift_qp
from dcvc_tpu_torch.legacy.dcvc_dc import DC_CONFIG, DMCDC
from dcvc_tpu_torch.legacy.dcvc_fm import DMCFM, FM_CONFIG
from dcvc_tpu_torch.legacy.compressai_zoo import BMSHJ2018_Q1_5, \
    CHENG2020_Q1_3, Cheng2020Anchor, ScaleHyperprior
from dcvc_tpu_torch.legacy.dcvc_hem import DMCHEM, HEM_CONFIG
from dcvc_tpu_torch.legacy.dcvc_net import DCVC_CONFIG, DCVCNet
from dcvc_tpu_torch.legacy.dcvc_tcm import DMCTCM, TCM_CONFIG
from dcvc_tpu_torch.legacy.evc import EVC_CONFIG, SCALABLE_EVC_CONFIG
from dcvc_tpu_torch.legacy.hem_intra import INTRA_NOAR_CONFIG, \
    INTRA_NOAR_FM_CONFIG
from dcvc_tpu_torch.legacy.rt_intra import DMCIRTConfig
from dcvc_tpu_torch.perf_probe import K1_GEMMS, K1_KERNELS, K2Log, Launch, \
    LaunchLog, block_inputs, cuda_ms, k1_bound_ms, k1_launch_flops, \
    k2_clock_summary, k2_fixtures, k2_lane_escapes, k2_lane_sizes, \
    k2_latency_bound_ms, ld_stage_launches, dc_p_codec, fm_p_codec, \
    hem_p_codec, hem_q_scales, lifted_legacy_intra, dcvc_p_codec, \
    lifted_compressai, \
    launch_counts, make_sequence, max_sm_clock_mhz, no_sync, nvidia_smi, \
    p_frame_calls, pipeline_cases, profile_launches, run_k2_case, \
    sync_free_halves, time_pipeline, warm_profiler, \
    rt_stage_launches, same, sass_counts, smooth_frame, \
    spatial_dmci_launches, \
    TRAIN_CELLS, TRAIN_INIT_SCALE, TRAIN_LAMBDAS, TRAIN_LR, damped_model, \
    tcm_p_codec, train_setup, uf_call_launches
from dcvc_tpu_torch.runtime.compressai_codec import Cheng2020Codec, \
    HyperpriorCodec
from dcvc_tpu_torch.runtime.evc_codec import EVCCodec, IntraNoARCodec
from dcvc_tpu_torch.runtime.image_codec import DMCICodec
from dcvc_tpu_torch.runtime.rt_image_codec import RTIntraCodec
from dcvc_tpu_torch.runtime.video_codec import DMCHTCodec, DMCLDCodec
from dcvc_tpu_torch.train import image_main as train_image_main
from dcvc_tpu_torch.train import video_main as train_video_main
from dcvc_tpu_torch.train.step import Optimizer, image_train_step
from dcvc_tpu_torch.train.video_step import video_train_step
from dcvc_tpu_torch.utils import download_checkpoints, import_cli, \
    profiling
from dcvc_tpu_torch.utils.checkpoint import load_latest_status, \
    load_reference_into, save_reference
from dcvc_tpu_torch.utils.jax_bridge import load_native_into, \
    native_config, save_native
from dcvc_tpu_torch.utils.metrics import calc_psnr
from dcvc_tpu_torch.utils.model_complexity import model_macs_per_pixel
from dcvc_tpu_torch.utils.png import load_rgb, write_png

K1_SOURCE = "dcvc_tpu_torch/csrc/fused_dcb.cu"
K2_SOURCE = "dcvc_tpu_torch/csrc/rans_decode.cu"
REPLACES = {
    "fused_dcb": "dcvc_tpu/kernels/fused_dcb.py:66",
    # the stacked form: _fused_dcb_stacked (its pallas_call at :210),
    # entry fused_dcb_stacked (:274)
    "fused_dcb_stacked": "dcvc_tpu/kernels/fused_dcb.py:164",
}
# K2: _decode_kernel, its pallas_call at :267 (make_decode_fn_pallas :232)
K2_REPLACES = "dcvc_tpu/rans/pallas_decode.py:75"

# the shape cases of tests/test_fused_dcb.py (W=18, dcb2, shortcut): not
# on the main path, checked first
TEST_SHAPES = [
    Launch("fused_dcb", 1, 8, 16, 128, 128, 128, False, False, False),
    Launch("fused_dcb", 1, 8, 18, 256, 128, 128, True, False, False),
    Launch("fused_dcb", 1, 6, 16, 128, 128, 64, False, False, False),
    Launch("fused_dcb", 1, 4, 16, 128, 128, 128, False, True, False),
]
# Tolerance of the kernel against the plain version, both in bfloat16:
# each rounds to bf16 (2^-9 relative) at several points, the plain version
# after each of its ~12 ops and the kernel at its 5 cast points, so the
# two may differ by a few bf16 steps of the output's magnitude.  Allowed:
# 2^-6 of the largest |output| (4 bf16 steps at the peak), per stack entry.
K1_REL_TOL = 2.0 ** -6
# Stage outputs of the full-width model in bf16 on the card against the
# same (bf16-valued) weights in float32 on the CPU: relative RMS error.
# ~40 successive bf16 roundings at 2^-9 each accumulate to ~1-2%
# (phase_stages also admits twice the plain bf16 version's error).
STAGE_REL_TOL = 5e-2
STAGE_QP = 32
# K1 launches of one DMCI encode / decode
ENCODE_LAUNCHES, DECODE_LAUNCHES = 42, 32
# main-path frames: (height, width, qp, seed); 720p gives the odd 45x80
# y grid
CODEC_CASES = [(1080, 1920, 0, 0), (1080, 1920, 32, 0), (720, 1280, 32, 1)]
# K2 launches of one DMCI device decode: z, then 4 rungs
DMCI_K2_LAUNCHES = 5
# video main paths: (height, width, qp, seed, reset flag of each coding
# unit: an 8-frame chunk for HT, a frame for LD), and the launches derived
# from the models: K1 (S = 1) per unit encode / decode without the recon
# head, later unit and right after the intra frame or a reset (which runs
# FA_I instead of FA_M); the recon head's (S = 1, stacked) launches per
# recon (decode, encode with recon=True) and per reset (HT: the last
# frame's head; LD: the head before its pixel shuffle); K2 launches per
# device decode
VIDEO = {
    # HTS: FA_I 4 blocks, FA_M 6; recon trunk + 3 head stacks; one y call
    "HTS": {"cfg": HTS_CONFIG, "codec": DMCHTCodec,
            "cases": [(1080, 1920, 32, 2, (False, True, False)),
                      (720, 1280, 32, 3, (False,))],
            "encode": 46, "decode": 37, "first_encode": 44,
            "first_decode": 35, "recon": (0, 4), "k2": 2},
    # HTL: FA_I 3, FA_M 10, encoder 7, decoder 11, FX 2; 5 head stacks, no
    # trunk; z + 4 y rungs
    "HTL": {"cfg": HTL_CONFIG, "codec": DMCHTCodec,
            "cases": [(1080, 1920, 32, 4, (False, True, False)),
                      (720, 1280, 32, 5, (False,))],
            "encode": 52, "decode": 42, "first_encode": 45,
            "first_decode": 35, "recon": (0, 5), "k2": 5},
    # LD: an intra frame, then 8 P frames at 1080p with a memory reset on
    # the fifth, and 2 at 720p (the odd 45x80 y grid); its counts come from
    # ld_spec; z + one y call
    "LD": {"cfg": LD_CONFIG, "codec": DMCLDCodec,
           "cases": [(1080, 1920, 32, 6,
                      (False, False, False, False, True, False, False, False)),
                     (720, 1280, 32, 7, (False, False))],
           "k2": 2},
}
# DCVC-RT (RGB in [0, 1]): its intra codec at DMCIRTConfig() (the
# 368-channel trunk) and its P codec at RT_CONFIG (init_scale 0.4, as
# dcvc_tpu's family runner draws it).  Cases: (height, width, qp, seed, P
# frames); the P frames code shift_qp(qp, INDEX_MAP[i % 8]) (the banks 32,
# 40 and 36 at qp 32), the lanes pinned to 2 (force_ec, as the RT SPS pins
# them at >= 1280x720); a P device decode launches K2 for z and each of
# the 2 checkerboard steps.  The family entry: family_main on a seeded
# 1080p YUV420 file of RT_FAMILY_FRAMES frames, gop 4, 2 rates.
RT_CASES = [(1080, 1920, 32, 13, 7), (720, 1280, 32, 14, 2)]
RT_FORCE_EC = 2
RT_K2_LAUNCHES = 3
RT_FAMILY_FRAMES = 6
# (S = 1, stacked, K2) launches of every counted call of a legacy codec
# (EVC, IntraNoAR, DCVC-FM, -HEM, -DC, -TCM, -2021, cheng2020,
# bmshj2018): float32, no K1Block, no K2 path
# (tests/test_torch_layers.py::test_legacy_models_launch_no_kernel)
NO_LAUNCHES = (0, 0, 0)
# the legacy intra codecs (RGB in [0, 1], float32, the weights of
# perf_probe.lifted_legacy_intra): (name, codec class, config, seed,
# sizes), each size at the two q_scales of tests/test_evc_codec.py; the
# warm 1080p encodes and decodes timed per codec (median); the card-vs-CPU
# stage check's side and its bound on the relative RMS error (float32 on
# both, TF32 off: the two differ in summation order only, ~1e-6 relative
# per layer over ~40 layers)
LEGACY_CODECS = [
    ("EVC", EVCCodec, EVC_CONFIG, 20, ((1080, 1920), (720, 1280))),
    ("IntraNoAR", IntraNoARCodec, INTRA_NOAR_CONFIG, 21,
     ((1080, 1920), (720, 1280))),
    ("scalable EVC", EVCCodec, SCALABLE_EVC_CONFIG, 22, ((720, 1280),)),
    ("IntraNoAR FM", IntraNoARCodec, INTRA_NOAR_FM_CONFIG, 23,
     ((720, 1280),)),
]
LEGACY_Q_SCALES = (0.8, 1.4)
LEGACY_TIMED = 3
LEGACY_STAGE_SIDE = 256
LEGACY_STAGE_REL_TOL = 1e-4
# DCVC-FM (RGB in [0, 1], float32): the legacy part's IntraNoAR codec
# (INTRA_NOAR_CONFIG, lifted) codes the intra frame that seeds the DPB at
# FM_I_Q_SCALE; DMCFMCodec at FM_CONFIG (perf_probe.fm_p_codec:
# lifted_fm's weights) codes the P frames, fa_idx from INDEX_MAP_FM.
# Cases: (height, width, seed, P frames), each at the q_indexes of the
# family runner's 2 rates; the warm 1080p P frame's encode and decode
# timed (median of FM_TIMED); the card-vs-CPU stage check at
# LEGACY_STAGE_SIDE within LEGACY_STAGE_REL_TOL.  The family entry:
# family_main --model fm on a seeded FM_FAMILY_W x FM_FAMILY_H YUV420
# file of FM_FAMILY_FRAMES frames, gop 4, 2 rates, twice, then --fast.
FM_CASES = [(1080, 1920, 32, 3), (720, 1280, 33, 2)]
FM_Q_INDEXES = (12, 51)
FM_I_Q_SCALE = 0.8
FM_TIMED = 3
FM_FAMILY_FRAMES = 6
FM_FAMILY_H, FM_FAMILY_W = 720, 1280
# DCVC-HEM and DCVC-DC: the cases, q indexes, intra frame and timing of
# DCVC-FM's part (phase_p_frames: HEM's q scales from the family runner's
# ladders at each q index, DC's fa_idx from INDEX_MAP_DC); their family
# entry: family_main --model hem and dc on a seeded 720p YUV420 file of
# HEM_DC_FAMILY_FRAMES frames, gop 4, 2 rates, then --model hem --fast
HEM_DC_FAMILY_FRAMES = 4
# The CompressAI intra codecs and DCVC-2021 (float32, seeded weights
# lifted as perf_probe.lifted_compressai / lifted_dcvc say): one 1080p
# image each for cheng2020 (CHENG2020_Q1_3) and bmshj2018 (BMSHJ2018_Q1_5),
# and DCVC_P_FRAMES DCVC P frames at 1080p from cheng2020's
# reconstruction; their masked-conv AR is the host's serial loop (~0.2-0.4
# ms per latent position), so the frames are few.  Their family_main run:
# DCVC_FAMILY_FRAMES 720p frames at gop 4, one rate, then --fast.
COMPRESSAI_SEEDS = {"cheng2020": 70, "bmshj2018": 71}
DCVC_CASE = (1080, 1920, 72)
DCVC_P_FRAMES = 2
DCVC_FAMILY_FRAMES = 4
# DCVC-TCM (float32, seeded weights lifted as perf_probe.lifted_tcm
# says): cases (height, width, seed, P frames), each from an intra frame
# of the bmshj2018 codec of the part before; the warm 1080p P frame's
# encode and decode timed (median of TCM_TIMED), split into the host rANS
# coder and the rest.  Its family_main run: TCM_FAMILY_FRAMES 720p frames
# at gop 4, one rate, then --fast, then with --model_path_p on the
# runner's own P model gone through save_reference and import_cli.
TCM_CASES = [(1080, 1920, 81, 3), (720, 1280, 82, 2)]
TCM_TIMED = 3
TCM_FAMILY_FRAMES = 4
# the evaluation entry's PNG source: PNG_FRAMES seeded 1080p frames
PNG_FRAMES = 3
# the evaluation entry's phase: a seeded 1080p YUV420 file of CLI_FRAMES
# frames, one intra frame then P frames (intra_period -1)
CLI_FRAMES = 10
CLI_H, CLI_W = 1080, 1920
# side of the synthetic training folders' frames (the trainers' 256 patch)
TRAIN_SIDE = 256
# the evaluation surface: the image CLI's seeded PNGs (height, width,
# seed); the BD gate's sequence length (run_bd_gate.py's default is 65);
# the card-vs-CPU symbol capture's frame side and QPs
IMAGE_CASES = [(1080, 1920, 40), (720, 1280, 41), (512, 768, 42)]
GATE_H, GATE_W, GATE_FRAMES = 256, 384, 33
SYMBOL_SIDE = 256
SYMBOL_QPS = (8, 32)


def log(*args):
    print(*args, flush=True)


def check_launch(key, gen, dev):
    """K1 (either form) against its plain version on random bf16 inputs at
    the shape of one launch, each stack entry held to K1_REL_TOL of its
    own peak; returns (max abs error, kernel ms, plain ms)."""
    x, p, run, ref = block_inputs(key, gen, dev)
    out = run()
    torch.cuda.synchronize()
    plain = ref(x, p)
    plain32 = ref(x.float(), {k: v.float() for k, v in p.items()})
    if key.kind == "fused_dcb":            # as a stack of one entry
        out, plain, plain32 = out[None], plain[None], plain32[None]
    errs = [(o.float() - q.float()).abs().max().item()
            for o, q in zip(out, plain)]
    peaks = [q.abs().max().item() for q in plain32]
    err32 = (out.float() - plain32).abs().max().item()
    plain_err32 = (plain.float() - plain32).abs().max().item()
    ok = bool(torch.isfinite(out).all()) and out.shape == plain.shape \
        and all(e <= K1_REL_TOL * pk for e, pk in zip(errs, peaks))
    t_k = cuda_ms(run)
    t_p = cuda_ms(lambda: ref(x, p))
    log(f"K1 {key}: max_abs_err={max(errs)} tol={K1_REL_TOL * min(peaks)}"
        f"..{K1_REL_TOL * max(peaks)} (vs f32 plain: kernel {err32}, bf16 "
        f"plain {plain_err32}) kernel_ms={t_k} plain_ms={t_p}")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version at {key}")
    return max(errs), t_k, t_p


def phase_sass():
    """Each kernel of K1's built library with its HGMMA (wgmma), UTMALDG
    (TMA load) and HMMA (mma.sync) instructions, from cuobjdump -sass.
    Fails unless every GEMM kernel of the chain has HGMMA and UTMALDG, the
    dw kernel is there, and no kernel has an HMMA."""
    counts = sass_counts(library_path("fused_dcb.cu"))
    log("K1 SASS, kernel: HGMMA UTMALDG HMMA: " + "; ".join(
        f"{k}: {v['HGMMA']} {v['UTMALDG']} {v['HMMA']}"
        for k, v in sorted(counts.items())))
    bases = {k.split("<")[0] for k in counts}
    bad = [k for k, v in counts.items() if k.split("<")[0] in K1_GEMMS
           and not (v["HGMMA"] and v["UTMALDG"])]
    bad += [k for k, v in counts.items() if v["HMMA"]]
    if bad or not bases >= set(K1_KERNELS):
        raise AssertionError(f"K1's SASS: kernels without wgmma / TMA or "
                             f"with mma.sync {bad}, kernels {sorted(bases)}")


def phase_launch_profile(heavy, total, gen, dev):
    """Each launch of K1's chain at the `heavy` shapes: device ms per call
    by kernel name (torch.profiler) and its TFLOP/s."""
    for key in heavy:
        _, _, run, _ = block_inputs(key, gen, dev)
        ms = profile_launches(run)
        flops = k1_launch_flops(key)
        parts = []
        for name in K1_KERNELS:
            if name not in flops:
                continue
            t = ms.get(name)
            parts.append(f"{name} {t} ms {flops[name] / t / 1e9} TFLOP/s"
                         if t else f"{name} not measured")
        log(f"K1 launches at {key} (main-path launches {total[key]}; "
            f"device ms per call, torch.profiler): " + "; ".join(parts))


def phase_edge_shapes(dev):
    """K1 against its plain version at the edge cases of the JAX package's
    tests (a partial tile, dcb2, the shortcut)."""
    gen = torch.Generator().manual_seed(1)
    for key in TEST_SHAPES:
        check_launch(key, gen, dev)


def phase_k2_fixtures(dev):
    """K2 against its plain version and the host decoder on the fixtures
    of the JAX package's decode tests: every call's symbols equal, zeros
    past the count, and the final lane states equal."""
    for case in k2_fixtures():
        st_k, outs_k = run_k2_case(case, dev, K2.rans_decode)
        torch.cuda.synchronize()
        st_p, outs_p = run_k2_case(case, dev, K2.rans_decode_reference)
        ok = (torch.equal(st_k["st"], st_p["st"])
              and torch.equal(st_k["ptr"], st_p["ptr"]))
        for (_, count, _, _, want), out_k, out_p in zip(case[3], outs_k,
                                                        outs_p):
            got = out_k.cpu().numpy()
            ok = ok and torch.equal(out_k, out_p) and np.array_equal(
                got[:count], want) and not got[count:].any()
        log(f"K2 fixture {case[0]} ({len(case[3])} calls): "
            f"{'equal to plain and host' if ok else 'DISAGREES'}")
        if not ok:
            raise AssertionError(f"K2 disagrees on the fixture {case[0]}")


def phase_kernels(dev, launch_log, launches):
    """Both forms of K1 against their plain versions at every distinct
    shape the main path launched them at.  Returns the kernel rows of the
    JSON table: ms / plain_ms is the device time of the main path's
    launches at the per-shape medians, bound_ms the sum over them of each
    launch's roofline bound (perf_probe.k1_bound_ms)."""
    gen = torch.Generator().manual_seed(0)
    total = launch_log.totals()
    rows = {kind: {"name": kind, "route": "cuda", "source": K1_SOURCE,
                   "replaces": REPLACES[kind], "launches": launches[kind],
                   "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "bound_by": None, "library_ms": None}
            for kind in REPLACES}
    bound_parts = {kind: [0.0, 0.0] for kind in REPLACES}
    times = {}
    for key in sorted(total):
        err, t_k, t_p = check_launch(key, gen, dev)
        flop_ms, byte_ms = k1_bound_ms(key)
        log(f"  main-path launches: {total[key]}; bound "
            f"{max(flop_ms, byte_ms)} ms (FLOPs {flop_ms}, bytes {byte_ms})")
        times[key] = (t_k, t_p)
        row = rows[key.kind]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += total[key] * t_k
        row["plain_ms"] += total[key] * t_p
        row["bound_ms"] += total[key] * max(flop_ms, byte_ms)
        bound_parts[key.kind][0] += total[key] * flop_ms
        bound_parts[key.kind][1] += total[key] * byte_ms
    heavy = sorted(total, key=lambda k: -total[k] * times[k][0])[:3]
    phase_launch_profile(heavy, total, gen, dev)
    for kind, (flop_ms, byte_ms) in bound_parts.items():
        rows[kind]["bound_by"] = ("operations" if flop_ms >= byte_ms
                                  else "bytes")
    for label, counts in launch_log.calls:
        if not counts:       # a call of a part that launches no kernel
            continue
        sums = {kind: [0, 0.0, 0.0, 0.0] for kind in REPLACES}
        for key, n in counts.items():
            s = sums[key.kind]
            s[0] += n
            s[1] += n * times[key][0]
            s[2] += n * times[key][1]
            s[3] += n * max(k1_bound_ms(key))
        log(f"K1 device time of {label} (per-shape medians x launches): "
            + "; ".join(f"{kind} launches={n} kernel_ms={k} plain_ms={p} "
                        f"bound_ms={b}"
                        for kind, (n, k, p, b) in sums.items() if n))
    return [rows[kind] for kind in REPLACES]


def phase_k2(k2_log, launches):
    """Every K2 call of the main path replayed on its recorded inputs:
    the kernel against its plain version (symbols and lane states equal),
    both timed (the kernel with CUDA events, the plain version, which runs
    on the host, by the host clock), and its cycle-counting build
    (-DK2_CLOCKS, equal symbols) for the SM clock under load, where a
    symbol's cycles go and which body decoded the aligned groups (the
    share kept from the escape-free body, the share it redid).  Prints one
    JSON line of K2 per main-path label.
    Returns K2's row of the JSON table; bound_ms is the latency bound of
    perf_probe.k2_latency_bound_ms (symbols and escapes, from the plain
    version's symbols) at the SM clock under load."""
    per_label = collections.defaultdict(lambda: {
        "launches": 0, "symbols": 0, "escapes": 0, "longest_lane_symbols": 0,
        "kernel_ms": 0.0, "plain_ms": 0.0, "calls": [], "escape_counts": [],
        "clocks": []})
    for call in k2_log.calls:
        args = call.args()
        st_k, out_k = K2.rans_decode_launch(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_p, out_p = K2.rans_decode_reference(*args)
        t_p = 1e3 * (time.perf_counter() - t0)
        st_c, out_c, clk = K2.rans_decode_clocks(*args)
        if not (torch.equal(out_k, out_p)
                and torch.equal(st_k["st"], st_p["st"])
                and torch.equal(st_k["ptr"], st_p["ptr"])
                and torch.equal(out_c, out_k)
                and torch.equal(st_c["st"], st_k["st"])
                and torch.equal(st_c["ptr"], st_k["ptr"])):
            raise AssertionError(f"K2 (or its cycle-counting build) "
                                 f"disagrees with its plain version on a "
                                 f"call of {call.label} {call.signature()}")
        t_k = cuda_ms(lambda: K2.rans_decode_launch(*args), iters=3,
                      warmup=1)
        esc = k2_lane_escapes(call, out_p)
        rec = per_label[call.label]
        rec["launches"] += 1
        rec["symbols"] += int(call.count)
        rec["escapes"] += sum(esc)
        rec["longest_lane_symbols"] += k2_lane_sizes(
            int(call.count), call.streams.shape[0])[-1]
        rec["kernel_ms"] += t_k
        rec["plain_ms"] += t_p
        rec["calls"].append(call)
        rec["escape_counts"].append(esc)
        rec["clocks"].append(clk)
    calls = [c for r in per_label.values() for c in r["calls"]]
    escapes = [e for r in per_label.values() for e in r["escape_counts"]]
    clocks = k2_clock_summary([c for r in per_label.values()
                               for c in r["clocks"]])
    clock = clocks["sm_clock_mhz"]
    max_clock = max_sm_clock_mhz()
    table = {}
    for label, r in per_label.items():
        table[label] = {
            k: r[k] for k in ("launches", "symbols", "escapes",
                              "longest_lane_symbols", "kernel_ms",
                              "plain_ms")}
        table[label]["ns_per_symbol_per_lane"] = \
            1e6 * r["kernel_ms"] / max(r["longest_lane_symbols"], 1)
        table[label]["bound_ms"] = k2_latency_bound_ms(
            r["calls"], clock, r["escape_counts"])
        summary = k2_clock_summary(r["clocks"])
        for k in ("cycles_per_symbol", "groups", "free_share", "redo_share"):
            table[label][k] = summary[k]
    ms = sum(r["kernel_ms"] for r in per_label.values())
    plain_ms = sum(r["plain_ms"] for r in per_label.values())
    bound = k2_latency_bound_ms(calls, clock, escapes)
    bound_old = k2_latency_bound_ms(calls, max_clock)
    longest = sum(r["longest_lane_symbols"] for r in per_label.values())
    log(json.dumps({"k2_per_label": table,
                    "k2_cycles_build": {k: v for k, v in clocks.items()},
                    "sm_clock_mhz_under_load": clock,
                    "max_sm_clock_mhz": max_clock,
                    "ns_per_symbol_per_lane": 1e6 * ms / max(longest, 1),
                    "bound_ms": bound,
                    "bound_ms_symbols_only_max_clock": bound_old}))
    log(f"K2 main path: {len(calls)} calls equal to plain (and the "
        f"cycle-counting build equal to the kernel); kernel_ms={ms} "
        f"plain_ms={plain_ms}; latency bound {bound} ms (symbols and "
        f"escapes at the {clock} MHz SM clock under load; symbols only at "
        f"{max_clock} MHz: {bound_old} ms)")
    return {"name": "rans_decode", "route": "cuda", "source": K2_SOURCE,
            "replaces": K2_REPLACES, "launches": launches,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations", "library_ms": None}


def rel_rms(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-12)).item()


def stage_outputs(model, x, qp, z_int8, ctx, y_hat, q_dec=None):
    """analysis, prior0, prior_step(1) and synthesis of `model` on a 64x64
    input; the shared inputs (z, ctx, y_hat and, for DCVC-RT's intra
    model, the q_dec map its synthesis takes) are the same for every
    model, moved to its device and type."""
    dev, dt = model.q_scale_enc.device, model.dtype
    rt = q_dec is not None
    with torch.inference_mode():
        y, _ = model.analysis(x.to(dev, dt), qp)
        prior = model.prior0(z_int8.to(dev), 4, 4)
        scales1, means1 = model.prior_step(ctx.to(dev, dt), y_hat.to(dev), 1)
        x_hat = model.synthesis(y_hat.to(dev), *(
            (q_dec.to(dev),) if rt else ()), qp, 64, 64)
    out = {"analysis y": y, "prior0 scales": prior[0],
           "prior0 means": prior[1], "prior0 ctx": prior[2],
           "prior_step scales": scales1, "prior_step means": means1,
           "synthesis x_hat": x_hat}
    if rt:
        out["prior0 q_enc"], out["prior0 q_dec"] = prior[3:]
    return out


def phase_stages(codec, name="DMCI"):
    """The full-width model's stages in bf16 on the card (every DCB through
    K1) against the same bf16-valued weights in float32 on the CPU (plain
    DCB).  A stage passes if its relative RMS error is within
    STAGE_REL_TOL, or within twice that of the plain version in bf16 (on
    the CPU): with random weights the decoder's activations grow through
    its 14 residual blocks, and bf16 error grows with them.  codec: a
    DMCICodec or an RTIntraCodec (frames in [0, 1])."""
    gpu = codec.model
    state = {k: v.float().cpu() for k, v in gpu.state_dict().items()}
    cpu32, cpu16 = codec.MODEL_CLS(codec.cfg), codec.MODEL_CLS(codec.cfg)
    cpu32.load_state_dict(state)
    cpu16.load_state_dict(state)
    cpu16.to(torch.bfloat16)
    rt = isinstance(codec, RTIntraCodec)
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(1, 64, 64, 3, generator=gen) - (0.0 if rt else 0.5)
    qp = STAGE_QP
    with torch.inference_mode():
        y, z_int8 = cpu32.analysis(x, qp)
        prior = cpu32.prior0(z_int8, 4, 4)
    y_hat = torch.round(y)
    args = (x, qp, z_int8, prior[2], y_hat) + ((prior[4],) if rt else ())
    compare_stages(name, stage_outputs(cpu32, *args),
                   stage_outputs(gpu, *args), stage_outputs(cpu16, *args))


def compare_stages(name, ref, got, plain):
    """Each stage output on the card (got) and of the plain bf16 model on
    the CPU (plain) against float32 on the CPU (ref), by relative RMS."""
    errs = {k: (rel_rms(got[k], ref[k]), rel_rms(plain[k], ref[k]))
            for k in ref}
    log(f"{name} stages vs f32 CPU, relative RMS (K1 path on the card, "
        f"plain bf16 on the CPU; tol {STAGE_REL_TOL} or 2x plain): "
        + json.dumps(errs))
    bad = [k for k, (e, e_plain) in errs.items()
           if not (e <= STAGE_REL_TOL or e <= 2 * e_plain)]
    if bad:
        raise AssertionError(f"{name} stage outputs disagree with the CPU: "
                             f"{bad}")


def stage_outputs_video(model, x, ref, feature, memory, z_int8, spctx,
                        y_hat, qp):
    """Every HTS / HTL / LD stage method of `model` on a 64x64 coding unit
    (/8 grid 8x8, y grid 4x4), each on the same shared inputs, moved to
    the model's device and type.  The HT recon_frames and reset_feature
    run the stacked kernel on the card."""
    dev, dt = model.q_encoder.device, model.dtype

    def m(t):
        return t.to(dev, dt)
    with torch.inference_mode():
        mem_i, ctx_i = model.adaptor_i(m(ref))
        mem_m, ctx_m = model.adaptor_m(m(memory), m(feature))
        y, _ = model.analysis(m(x), m(feature), qp)
        q_enc, q_dec, scales, means, ctx0 = model.prior0(
            z_int8.to(dev), m(memory), qp, 4, 4)
        if model.cfg.prior_steps == 4:
            step = model.prior_step(m(spctx), y_hat.to(dev), 1)
        else:                     # the checkerboard's second step
            step = model.prior_step(m(spctx), y_hat.to(dev))
        feat = model.synthesis_feature(y_hat.to(dev), m(feature), qp)
        frames = model.recon_frames(m(feature), qp, 64, 64)
        seed = model.reset_feature(m(feature))
    out = {"adaptor_i memory": mem_i, "adaptor_i ctx": ctx_i,
           "adaptor_m memory": mem_m, "adaptor_m ctx": ctx_m,
           "analysis y": y, "prior0 q_dec": q_dec, "prior0 scales": scales,
           "prior0 means": means, "prior0 ctx": ctx0,
           "synthesis_feature": feat, "recon_frames": frames,
           "reset_feature": seed}
    if model.cfg.single_pass:     # HTS, LD: means only
        out["prior_step means"] = step
    else:
        out["prior_step scales"], out["prior_step means"] = step
    return out


def phase_stages_video(name, codec):
    """The full-width video model's stages in bf16 on the card (every DCB
    through K1, the recon heads through its stacked form) against the
    same bf16-valued weights in float32 on the CPU; the rule of
    phase_stages."""
    gpu = codec.model
    state = {k: v.float().cpu() for k, v in gpu.state_dict().items()}
    cpu32, cpu16 = codec.MODEL(codec.cfg), codec.MODEL(codec.cfg)
    cpu32.load_state_dict(state)
    cpu16.load_state_dict(state)
    cpu16.to(torch.bfloat16)
    c = codec.cfg
    gen = torch.Generator().manual_seed(2)
    # DCVC-RT's frames lie in [0, 1], the UF models' in [-0.5, 0.5]
    lo = 0.0 if name == "RT" else -0.5
    x = torch.rand(1, 64, 64, 3 * c.frame_delay, generator=gen) + lo
    # an intra frame's unshuffled pixels (HT: ch_src_intra, LD: ch_src, RT:
    # ch_src_d); RT's memory is its adapted feature (ch_d)
    ch_ref = next(getattr(c, k) for k in ("ch_src_intra", "ch_src",
                                          "ch_src_d") if hasattr(c, k))
    ref = torch.rand(1, 8, 8, ch_ref, generator=gen) + lo
    feature = torch.randn(1, 8, 8, c.ch_d, generator=gen)
    memory = torch.randn(1, 8, 8, getattr(c, "ch_m", c.ch_d), generator=gen)
    qp = STAGE_QP
    with torch.inference_mode():
        y, z_int8 = cpu32.analysis(x, feature, qp)
        spctx = cpu32.prior0(z_int8, memory, qp, 4, 4)[4]
    y_hat = torch.round(y)
    args = (x, ref, feature, memory, z_int8, spctx, y_hat, qp)
    compare_stages(name, stage_outputs_video(cpu32, *args),
                   stage_outputs_video(gpu, *args),
                   stage_outputs_video(cpu16, *args))


def counted(launch_log, label, fn):
    """fn() on a synchronised card, its launches recorded under `label`;
    returns (result, ms, S = 1 launches, stacked launches, K2 launches)."""
    n1, ns = K1.fused_dcb.launches, K1.fused_dcb_stacked.launches
    n2 = K2.rans_decode.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with launch_log.call(label):
        out = fn()
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return (out, ms, K1.fused_dcb.launches - n1,
            K1.fused_dcb_stacked.launches - ns, K2.rans_decode.launches - n2)


def expect(tag, got, want):
    if got != want:
        raise AssertionError(f"{tag}: (S=1, stacked, K2) launches {got}, "
                             f"expected {want}")


def device_decode(codec, k2_log, label, launch_log, stream, ec, *args):
    """One device decode (device_ec) of `stream`: its lanes uploaded, then
    the decode under no_sync.  Returns counted()'s tuple."""
    codec.device_ec = True
    try:
        lanes = codec.upload_stream(stream, ec)
        k2_log.label = label
        return counted(launch_log, label, lambda: no_sync(
            lambda: codec.decompress(lanes, *args)["x_hat"]))
    finally:
        codec.device_ec = False


def phase_codec(codec, dev, launch_log, k2_log, cases=CODEC_CASES):
    """The main path's image half: DMCI round trips at 1080p (two QPs) and
    720p (`cases`), cold then warm, then each stream decoded on the
    device (K2, sync-checked).  Returns the (S = 1, stacked, K2) launches
    derived for it, each call's checked."""
    derived = [0, 0, 0]
    for (h, w, qp, seed) in cases:
        x = smooth_frame(h, w, seed, dev)
        runs = []
        for run in ("cold", "warm"):
            tag = f"DMCI {w}x{h} qp={qp} {run}"
            res, enc_ms, e1, es, e2 = counted(launch_log, f"{tag} encode",
                                              lambda: codec.compress(x, qp))
            x_dec, dec_ms, d1, ds, d2 = counted(
                launch_log, f"{tag} decode", lambda: codec.decompress(
                    bytes(res["bit_stream"]), qp, h, w,
                    res["ec_parallel"])["x_hat"])
            x_enc = res["x_hat"]
            if x_dec.shape != (1, h, w, 3) or x_enc.shape != x_dec.shape:
                raise AssertionError(f"x_hat shape {tuple(x_dec.shape)}")
            if not bool(torch.isfinite(x_dec).all()):
                raise AssertionError("non-finite reconstruction")
            if not torch.equal(x_enc, x_dec):
                raise AssertionError(f"{tag}: decoder x_hat differs from "
                                     f"the encoder's")
            expect(f"{tag} encode", (e1, es, e2), (ENCODE_LAUNCHES, 0, 0))
            expect(f"{tag} decode", (d1, ds, d2), (DECODE_LAUNCHES, 0, 0))
            derived[0] += ENCODE_LAUNCHES + DECODE_LAUNCHES
            runs.append((res, x_dec, e1, d1, enc_ms, dec_ms))
        if runs[0][0]["bit_stream"] != runs[1][0]["bit_stream"]:
            raise AssertionError(f"{h}p qp {qp}: two encodes of one frame "
                                 f"gave different streams")
        res, x_dec, n_enc, n_dec, enc_ms, dec_ms = runs[1]
        tag = f"DMCI {w}x{h} qp={qp}"
        x_dev, dev_ms, v1, vs, v2 = device_decode(
            codec, k2_log, f"{tag} device decode", launch_log,
            bytes(res["bit_stream"]), res["ec_parallel"], qp, h, w,
            res["ec_parallel"])
        if not (torch.equal(x_dev, res["x_hat"]) and torch.equal(x_dev,
                                                                  x_dec)):
            raise AssertionError(f"{tag}: the device decode's x_hat differs "
                                 f"from the encoder's / host decode's")
        expect(f"{tag} device decode", (v1, vs, v2),
               (DECODE_LAUNCHES, 0, DMCI_K2_LAUNCHES))
        derived[0] += DECODE_LAUNCHES
        derived[2] += DMCI_K2_LAUNCHES
        nbytes = len(res["bit_stream"])
        mse = torch.mean((x_dec - x) ** 2).item()
        psnr = 10 * torch.log10(torch.tensor(1.0 / mse)).item()
        log(f"{tag}: bytes={nbytes} bpp={8 * nbytes / (h * w)} "
            f"psnr={psnr} ec_parallel={res['ec_parallel']} bit_exact=True "
            f"launches enc={n_enc} dec={n_dec} device_dec={v1}+K2 {v2} "
            f"warm encode_ms={enc_ms} decode_ms={dec_ms} "
            f"device_decode_ms={dev_ms}")
    return tuple(derived)


def ld_spec(spec):
    """Fills VIDEO['LD']'s K1 launches per call from the model
    (perf_probe.ld_stage_launches: its stage methods on the meta device,
    in the codec's order) and returns the distinct K1 shapes of its cases,
    which the card's launch log must repeat."""
    shapes, counts = set(), set()
    for (h, w, *_) in spec["cases"]:
        stages = ld_stage_launches(spec["cfg"], h, w)
        n = {k: sum(v.values()) for k, v in stages.items()}
        counts.add(tuple(sorted(n.items())))
        for v in stages.values():
            shapes.update(v)
    if len(counts) != 1:
        raise AssertionError(f"LD launch counts differ by size: {counts}")
    trunk = n["prior0"] + n["prior_step"] + n["synthesis_feature"]
    if n["reset_feature"] != n["recon_frames"]:
        raise AssertionError(f"LD reset and recon differ: {n}")
    spec.update(decode=n["adaptor_m"] + trunk,
                first_decode=n["adaptor_i"] + trunk,
                encode=n["adaptor_m"] + n["analysis"] + trunk,
                first_encode=n["adaptor_i"] + n["analysis"] + trunk,
                recon=(n["recon_frames"], 0))
    log(f"LD K1 launches from the model: per stage {n}; encode "
        f"{spec['encode']} (first {spec['first_encode']}), decode "
        f"{spec['decode']} (first {spec['first_decode']}), + "
        f"{n['recon_frames']} per recon and per reset; "
        f"{len(shapes)} distinct shapes")
    return shapes


def unit_launches(spec, first, reset, encode, recon):
    """(S = 1, stacked, K2) launches of one coding unit's encode or
    (host-coder) decode; first: right after the intra frame or a reset; a
    device decode adds spec['k2'] K2 launches."""
    if encode:
        s1 = spec["first_encode"] if first else spec["encode"]
    else:
        s1 = spec["first_decode"] if first else spec["decode"]
    n = int(reset) + int(recon)
    return s1 + spec["recon"][0] * n, spec["recon"][1] * n, 0


def expected_launches(spec, resets, u, encode, recon):
    """unit_launches of unit u of a sequence with these reset flags."""
    return unit_launches(spec, u == 0 or resets[u - 1], resets[u], encode,
                         recon)


def phase_video(name, dmci, codec, dev, launch_log, k2_log, cases=None):
    """The main path's video half for one variant: the DMCI reconstruction
    of a sequence's first frame seeds the video codec, which codes the
    sequence in units of frame_delay frames (HT: 8-frame chunks, LD:
    frames).  Encode pass 1 (recon=True) against a host-coder decode and a
    device decode (K2, every call sync-checked), each from a fresh DPB:
    every unit's x_hat and the final DPB bit-exact; encode pass 2
    (recon=False, warm): the same streams.  cases: VIDEO[name]'s unless
    given.  Returns the (S = 1, stacked, K2) launches derived for it, each
    call's checked."""
    spec = VIDEO[name]
    fd = spec["cfg"].frame_delay
    unit = "chunk" if fd > 1 else "frame"
    derived = [0, 0, 0]

    def tally(tag, got, want):
        expect(tag, got, want)
        for i in range(3):
            derived[i] += want[i]

    for (h, w, qp, seed, resets) in cases or spec["cases"]:
        frames = make_sequence(h, w, fd * len(resets), seed, dev)
        chunks = [torch.cat(frames[fd * u:fd * u + fd], dim=-1)
                  for u in range(len(resets))]
        label = f"{name} {w}x{h} qp={qp}"
        intra, _, i1, is_, i2 = counted(
            launch_log, f"{label} intra frame (DMCI encode)",
            lambda: dmci.compress(frames[0], qp)["x_hat"])
        tally(f"{label} intra frame", (i1, is_, i2), (ENCODE_LAUNCHES, 0, 0))

        def seeded():
            codec.clear_dpb()
            codec.add_ref_feature_from_frame(intra)

        def encode(recon):
            seeded()
            kind = "encode (recon)" if recon else "encode"
            runs = [counted(launch_log, f"{label} {unit} {u} {kind}",
                            lambda: codec.compress(x, qp, rs, recon=recon))
                    for u, (x, rs) in enumerate(zip(chunks, resets))]
            return runs, codec.ref_feature

        enc1, dpb1 = encode(True)
        enc2, dpb2 = encode(False)
        seeded()
        dec = [counted(launch_log, f"{label} {unit} {u} decode",
                       lambda: codec.decompress(
                           bytes(r[0]["bit_stream"]), qp, h, w,
                           r[0]["ec_parallel"], rs)["x_hat"])
               for u, (r, rs) in enumerate(zip(enc1, resets))]
        dpb_host = codec.ref_feature
        seeded()
        ddec = [device_decode(codec, k2_log,
                              f"{label} {unit} {u} device decode",
                              launch_log, bytes(r[0]["bit_stream"]),
                              r[0]["ec_parallel"], qp, h, w,
                              r[0]["ec_parallel"], rs)
                for u, (r, rs) in enumerate(zip(enc1, resets))]
        dpb_dev = codec.ref_feature
        for u, rs in enumerate(resets):
            tag = f"{label} {unit} {u} reset={int(rs)}"
            (r1, _, e1, s1, _), (r2, enc_ms, e2, s2, _) = enc1[u], enc2[u]
            x_dec, dec_ms, d1, ds, dk = dec[u]
            x_dev, dev_ms, v1, vs, vk = ddec[u]
            if x_dec.shape != (fd, h, w, 3) \
                    or r1["x_hat"].shape != x_dec.shape:
                raise AssertionError(f"{tag}: x_hat shape "
                                     f"{tuple(x_dec.shape)}")
            if not bool(torch.isfinite(x_dec).all()):
                raise AssertionError(f"{tag}: non-finite reconstruction")
            if not torch.equal(r1["x_hat"], x_dec):
                raise AssertionError(f"{tag}: decoder x_hat differs from "
                                     f"the encoder's")
            if not torch.equal(x_dev, x_dec):
                raise AssertionError(f"{tag}: the device decode's x_hat "
                                     f"differs from the host decode's")
            if r1["bit_stream"] != r2["bit_stream"]:
                raise AssertionError(f"{tag}: two encodes gave different "
                                     f"streams")
            tally(f"{tag} encode (recon)", (e1, s1, enc1[u][4]),
                  expected_launches(spec, resets, u, True, True))
            tally(f"{tag} encode", (e2, s2, enc2[u][4]),
                  expected_launches(spec, resets, u, True, False))
            tally(f"{tag} decode", (d1, ds, dk),
                  expected_launches(spec, resets, u, False, True))
            s1_, st_, _ = expected_launches(spec, resets, u, False, True)
            tally(f"{tag} device decode", (v1, vs, vk),
                  (s1_, st_, spec["k2"]))
            nbytes = len(r1["bit_stream"])
            src = torch.cat(frames[fd * u:fd * u + fd]).float()
            mse = torch.mean((x_dec - src) ** 2).item()
            psnr = 10 * torch.log10(torch.tensor(1.0 / mse)).item()
            log(f"{tag}: bytes={nbytes} bpp={8 * nbytes / (fd * h * w)} "
                f"psnr={psnr} ec_parallel={r1['ec_parallel']} "
                f"bit_exact=True launches enc(recon)={e1}+{s1} "
                f"enc={e2}+{s2} dec={d1}+{ds} device_dec={v1}+{vs}+K2 {vk} "
                f"warm encode_ms={enc_ms} encode_recon_ms={enc1[u][1]} "
                f"decode_ms={dec_ms} device_decode_ms={dev_ms}")
        if not all(torch.equal(dpb1, d) for d in (dpb2, dpb_host, dpb_dev)):
            raise AssertionError(f"{label}: a final DPB differs (encoder, "
                                 f"host decode, device decode)")
        log(f"{label}: final DPB equal on the encoder, the host decode and "
            f"the device decode {tuple(dpb1.shape)}")
    return tuple(derived)


# the pipelined calls: perf_probe.pipeline_cases at 1080p, qp 32, on the
# main path's codecs; PIPELINE_RUNS timed runs of each form per job, then
# one profiled run of each
PIPELINE_RUNS = 1


def pipeline_unit_launches(case, rt):
    """(S = 1, stacked, K2) launches of each unit of one call of a
    PipelineCase: DMCI's from ENCODE_LAUNCHES / DECODE_LAUNCHES, RT
    intra's from rt (rt_spec), a video unit's from VIDEO
    (expected_launches: a decode runs the recon heads, an encode does
    not); a device decode adds each unit's K2 calls."""
    encode, k2 = case.kind == "encode", case.kind == "device decode"
    if case.name == "DMCI":
        n = ENCODE_LAUNCHES if encode else DECODE_LAUNCHES
        return [(n, 0, DMCI_K2_LAUNCHES if k2 else 0)] * len(case.resets)
    if case.name == "RT intra":
        return [(rt["encode" if encode else "decode"], 0, 0)] \
            * len(case.resets)
    spec = VIDEO[case.name]
    return [expected_launches(spec, case.resets, u, encode, not encode)[:2]
            + (spec["k2"] if k2 else 0,) for u in range(len(case.resets))]


def phase_pipeline(dev, launch_log, codecs, rt):
    """The pipelined calls against the serial ones (perf_probe's
    pipeline_cases, time_pipeline): DMCI compress_many / decompress_many
    over 8 1080p images (host coder and K2), RT intra's over 4, and
    compress_sequence / decompress_sequence (host coder and K2) of HTS over
    a DMCI frame + 6 chunks of 8 frames, HTL over 3 chunks and LD over 8
    frames, a reset in each.  Every run must give the serial run's bytes,
    frames and final DPB bit for bit, and the encoder's; every
    compress_async and every K2 decode runs under no_sync; each
    compress_async launches K1 and K2 as derived for its unit, and each job
    as derived for its units.  Prints each job's warm walls per unit,
    serial and pipelined, with the device's idle share.  Returns the
    (S = 1, stacked, K2) launches derived for it."""
    derived = [0, 0, 0]

    def tally(tag, got, want):
        expect(tag, got, want)
        for i in range(3):
            derived[i] += want[i]

    with sync_free_halves(codecs) as halves:
        with launch_log.call("pipeline inputs"):
            before = launch_counts()
            cases = pipeline_cases(codecs, dev)
            got = tuple(a - b for a, b in zip(launch_counts(), before))
        # the inputs' calls: each job's serial call once, and each
        # sequence's DMCI frame
        want = [0, 0, 0]
        for case in cases:
            for unit in pipeline_unit_launches(case, rt):
                for i in range(3):
                    want[i] += unit[i]
            if case.kind == "encode" and case.name in VIDEO:
                want[0] += ENCODE_LAUNCHES
        tally("pipeline inputs", got, tuple(want))
        warm_profiler(dev)
        calls = 2 * PIPELINE_RUNS + 2
        for case in cases:
            label = f"pipeline {case.name} {case.kind}"
            units = pipeline_unit_launches(case, rt)
            for log_ in halves.values():
                log_.clear()
            with launch_log.call(label):
                before = launch_counts()
                line = time_pipeline(case, PIPELINE_RUNS)
                got = tuple(a - b for a, b in zip(launch_counts(), before))
            tally(label, got, tuple(calls * sum(u[i] for u in units)
                                    for i in range(3)))
            if case.kind == "encode" and halves[case.name] != units * calls:
                raise AssertionError(f"{label}: compress_async launches "
                                     f"{halves[case.name]}, derived "
                                     f"{units * calls}")
            log(f"{label}: {len(units)} units, serial and pipelined "
                f"bit-exact (bytes, frames, final DPB), every device half "
                f"sync-free; ms per unit serial "
                f"{line['serial_median_ms_per_unit']} pipelined "
                f"{line['pipelined_median_ms_per_unit']} (x"
                f"{line['serial_over_pipelined']}), idle share serial "
                f"{line['serial_idle_share']} pipelined "
                f"{line['pipelined_idle_share']}; launches {got}")
    return tuple(derived)


TRACED_SPANS = {
    "codec.compress_many", "codec.compress_async", "stage.analysis",
    "copy.start", "stage.prior", "stage.quant", "stage.step",
    "stage.synthesis", "codec.compress_finish", "wait.copy",
    "entropy.encode", "entropy.upload", "codec.decompress_many",
    "codec.decode_unit", "entropy.decode_z", "entropy.decode_y",
    "k1.launch", "k2.launch", "codec.dpb_seed", "stage.seed",
    "stage.adaptor", "stage.final", "codec.compress_sequence",
    "codec.decompress_sequence", "stage.recon"}


def phase_traced(dmci, hts, dev, h=1080, w=1920, qp=32):
    """The sync-free device decodes once more with the program's recorder
    on (module docstring): DMCI over 2 images, HTS over 2 chunks seeded
    with a DMCI frame, all inside one torch.profiler window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    images = [smooth_frame(h, w, seed, dev) for seed in (40, 41)]
    frames = make_sequence(h, w, 16, 42, dev)
    chunks = [torch.cat(frames[8 * u:8 * u + 8], dim=-1) for u in range(2)]
    intra = dmci.compress(frames[0], qp)["x_hat"]
    qps = [qp, qp]

    def device_decode(codec, decode, res):
        lanes = [codec.upload_stream(bytes(r["bit_stream"]),
                                     r["ec_parallel"]) for r in res]
        codec.device_ec = True
        try:
            return no_sync(lambda: decode(
                lanes, qps, h, w, [r["ec_parallel"] for r in res]))
        finally:
            codec.device_ec = False

    def seed():
        hts.clear_dpb()
        hts.add_ref_feature_from_frame(intra)

    def run():
        res = dmci.compress_many(images, qps)
        outs = device_decode(dmci, dmci.decompress_many, res)
        for r, o in zip(res, outs):
            if not torch.equal(r["x_hat"], o["x_hat"]):
                raise AssertionError("traced DMCI: the device decode's x_hat "
                                     "differs from the encoder's")
        seed()
        seq = hts.compress_sequence(chunks, qps)
        dpb = (hts.ref_feature, hts.memory)
        seed()
        device_decode(hts, hts.decompress_sequence, seq)
        if not same(dpb, (hts.ref_feature, hts.memory)):
            raise AssertionError("traced HTS: the device decode's DPB "
                                 "differs from the encoder's")
        torch.cuda.synchronize()

    run()                              # warm, the recorder off
    profiling.reset()
    with sync_free_halves({"DMCI": dmci, "HTS": hts}):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            run()
            wall = time.perf_counter() - t0
    rec = profiling.records()
    profiling.reset()
    names = collections.Counter(s[0] for s in rec["spans"])
    if set(names) != TRACED_SPANS or rec["dropped"]:
        raise AssertionError(f"traced: spans {dict(names)} (dropped "
                             f"{rec['dropped']}), expected "
                             f"{sorted(TRACED_SPANS)}")
    if rec["counters"].get("entropy.symbols", 0) <= 0:
        raise AssertionError(f"traced: counters {rec['counters']}")
    mirrored = [e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA and e.name in names]
    scopes = {int(e.scope) for e in prof.events()
              if e.device_type != DeviceType.CUDA and e.name in names}
    if mirrored or scopes != {0}:
        raise AssertionError(f"traced: device events named as spans "
                             f"{mirrored[:5]}, host scopes {scopes}")
    log(f"traced sync-free decodes: DMCI 2 images, HTS 2 chunks at "
        f"{w}x{h} qp={qp} bit-exact, every compress_async and device "
        f"decode sync-free with the recorder on; {len(rec['spans'])} spans "
        f"({dict(names)}), counters {rec['counters']}, no device event "
        f"named as a span, host events FUNCTION-scope; {wall:.3f} s")


def rt_spec(dtype=torch.bfloat16):
    """DCVC-RT's K1 launches per call, from the models in `dtype` on the
    meta device (perf_probe.rt_stage_launches, at each RT_CASES size):
    {"encode", "decode"} of the intra codec and the P codec's stage counts
    {"p.<stage>"}; and the distinct K1 shapes, which the card's launch log
    must repeat."""
    shapes, counts = set(), set()
    for (h, w, *_) in RT_CASES:
        stages = rt_stage_launches(DMCIRTConfig(), RT_CONFIG, h, w, dtype)
        n = {k: sum(v.values()) for k, v in stages.items()}
        counts.add(tuple(sorted(n.items())))
        for v in stages.values():
            shapes.update(v)
    if len(counts) != 1:
        raise AssertionError(f"RT launch counts differ by size: {counts}")
    decode = n["prior0"] + sum(n[f"prior_step {k}"] for k in (1, 2, 3)) \
        + n["synthesis"]
    spec = {"encode": n["analysis"] + decode, "decode": decode,
            **{k: v for k, v in n.items() if k.startswith("p.")}}
    log(f"RT K1 launches from the models in {dtype}: intra per stage "
        f"{ {k: v for k, v in n.items() if not k.startswith('p.')} }; "
        f"encode {spec['encode']}, decode {spec['decode']}; P codec per "
        f"stage { {k: v for k, v in n.items() if k.startswith('p.')} } (its "
        f"two-way DCBs, K1's two-plane form); {len(shapes)} distinct "
        f"shapes")
    return spec, shapes


def rt_p_launches(spec, first, encode, recon):
    """(S = 1, stacked, K2) launches of one RT P frame's encode or
    (host-coder) decode; first: right after the intra frame."""
    n = spec["p.adaptor_i" if first else "p.adaptor_m"] + spec["p.prior0"] \
        + spec["p.prior_step"] + spec["p.synthesis_feature"]
    n += spec["p.analysis"] if encode else 0
    n += spec["p.recon_frames"] if recon else 0
    return n, 0, 0


def phase_rt(intra, pcodec, spec, dev, launch_log, k2_log):
    """The main path's DCVC-RT part: at each RT_CASES size an intra frame
    (RTIntraCodec, cold then warm: the same stream; host decode bit-exact,
    in [0, 1]), then P frames (DMCRTCodec, seeded by the intra frame's
    reconstruction) at shift_qp's banks: encode pass 1 (recon=True) against
    a host-coder decode and a device decode (K2, every call
    sync-checked), each from a fresh DPB: every frame's x_hat and the
    final DPB bit-exact; encode pass 2 (recon=False, warm): the same
    streams.  Every stream's lanes are pinned to RT_FORCE_EC.  Prints the
    warm ms per frame.  Returns the (S = 1, stacked, K2) launches derived
    for it, each call's checked."""
    derived = [0, 0, 0]

    def tally(tag, got, want):
        expect(tag, got, want)
        for i in range(3):
            derived[i] += want[i]

    intra.force_ec = pcodec.force_ec = RT_FORCE_EC
    try:
        for (h, w, qp, seed, n_p) in RT_CASES:
            frames = [f + 0.5 for f in make_sequence(h, w, n_p + 1, seed,
                                                     dev)]
            label = f"RT {w}x{h} qp={qp}"
            runs = []
            for run in ("cold", "warm"):
                res, enc_ms, *e = counted(
                    launch_log, f"{label} intra encode {run}",
                    lambda: intra.compress(frames[0], qp))
                x_dec, dec_ms, *d = counted(
                    launch_log, f"{label} intra decode {run}",
                    lambda: intra.decompress(bytes(res["bit_stream"]), qp, h,
                                             w, res["ec_parallel"])["x_hat"])
                tally(f"{label} intra encode", tuple(e),
                      (spec["encode"], 0, 0))
                tally(f"{label} intra decode", tuple(d),
                      (spec["decode"], 0, 0))
                if x_dec.shape != (1, h, w, 3) or not torch.equal(
                        res["x_hat"], x_dec) or res["ec_parallel"] != \
                        RT_FORCE_EC:
                    raise AssertionError(f"{label} intra: decoder x_hat "
                                         f"differs from the encoder's, or "
                                         f"ec_parallel "
                                         f"{res['ec_parallel']}")
                if not (bool(torch.isfinite(x_dec).all())
                        and 0.0 <= float(x_dec.min())
                        and float(x_dec.max()) <= 1.0):
                    raise AssertionError(f"{label} intra: reconstruction "
                                         f"not finite or not in [0, 1]")
                runs.append((res, enc_ms, dec_ms))
            if runs[0][0]["bit_stream"] != runs[1][0]["bit_stream"]:
                raise AssertionError(f"{label} intra: two encodes gave "
                                     f"different streams")
            res, i_enc_ms, i_dec_ms = runs[1]
            intra_hat = res["x_hat"]
            qps = [shift_qp(qp, INDEX_MAP[i % len(INDEX_MAP)])
                   for i in range(1, n_p + 1)]
            tags = [f"{label} P frame {i} qp={q}" for i, q in
                    enumerate(qps, 1)]

            def seeded():
                pcodec.clear_dpb()
                pcodec.add_ref_feature_from_frame(intra_hat)

            def encode(recon):
                seeded()
                kind = "encode (recon)" if recon else "encode"
                out = [counted(launch_log, f"{tag} {kind}",
                               lambda: pcodec.compress(x, q, recon=recon))
                       for tag, x, q in zip(tags, frames[1:], qps)]
                return out, pcodec.ref_feature

            enc1, dpb1 = encode(True)
            enc2, dpb2 = encode(False)
            seeded()
            dec = [counted(launch_log, f"{tag} decode",
                           lambda: pcodec.decompress(
                               bytes(r[0]["bit_stream"]), q, h, w,
                               r[0]["ec_parallel"])["x_hat"])
                   for tag, r, q in zip(tags, enc1, qps)]
            dpb_host = pcodec.ref_feature
            seeded()
            ddec = [device_decode(pcodec, k2_log, f"{tag} device decode",
                                  launch_log, bytes(r[0]["bit_stream"]),
                                  r[0]["ec_parallel"], q, h, w,
                                  r[0]["ec_parallel"])
                    for tag, r, q in zip(tags, enc1, qps)]
            dpb_dev = pcodec.ref_feature
            ms = collections.defaultdict(list)
            for u, tag in enumerate(tags):
                (r1, rec_ms, *e1), (r2, enc_ms, *e2) = enc1[u], enc2[u]
                x_dec, dec_ms, *d = dec[u]
                x_dev, dev_ms, *v = ddec[u]
                if not (torch.equal(r1["x_hat"], x_dec)
                        and torch.equal(x_dev, x_dec)):
                    raise AssertionError(f"{tag}: the host or device "
                                         f"decode's x_hat differs from the "
                                         f"encoder's")
                if x_dec.shape != (1, h, w, 3) or not bool(
                        torch.isfinite(x_dec).all()):
                    raise AssertionError(f"{tag}: x_hat "
                                         f"{tuple(x_dec.shape)} or not "
                                         f"finite")
                if r1["bit_stream"] != r2["bit_stream"] or \
                        r1["ec_parallel"] != RT_FORCE_EC:
                    raise AssertionError(f"{tag}: two encodes gave "
                                         f"different streams, or "
                                         f"ec_parallel {r1['ec_parallel']}")
                tally(f"{tag} encode (recon)", tuple(e1),
                      rt_p_launches(spec, u == 0, True, True))
                tally(f"{tag} encode", tuple(e2),
                      rt_p_launches(spec, u == 0, True, False))
                tally(f"{tag} decode", tuple(d),
                      rt_p_launches(spec, u == 0, False, True))
                s1, st, _ = rt_p_launches(spec, u == 0, False, True)
                tally(f"{tag} device decode", tuple(v),
                      (s1, st, RT_K2_LAUNCHES))
                nbytes = len(r1["bit_stream"])
                mse = torch.mean((x_dec - frames[u + 1]) ** 2).item()
                log(f"{tag}: bytes={nbytes} bpp={8 * nbytes / (h * w)} "
                    f"psnr={10 * np.log10(1.0 / mse)} "
                    f"ec_parallel={r1['ec_parallel']} bit_exact=True warm "
                    f"encode_ms={enc_ms} encode_recon_ms={rec_ms} "
                    f"decode_ms={dec_ms} device_decode_ms={dev_ms}")
                for k, t in (("encode", enc_ms), ("decode", dec_ms),
                             ("device_decode", dev_ms)):
                    ms[k].append(t)
            if not all(torch.equal(dpb1, d) for d in (dpb2, dpb_host,
                                                       dpb_dev)):
                raise AssertionError(f"{label}: a final DPB differs "
                                     f"(encoder, host decode, device "
                                     f"decode)")
            log(f"{label} warm ms per frame (host clock, synchronised): "
                f"intra encode {i_enc_ms} decode {i_dec_ms}; P frames "
                f"(mean of {n_p}) "
                + " ".join(f"{k} {statistics.mean(v)}"
                           for k, v in ms.items())
                + f"; final DPB equal on the encoder, the host decode and "
                f"the device decode {tuple(dpb1.shape)}")
    finally:
        intra.force_ec = pcodec.force_ec = None
    return tuple(derived)


def phase_rt_family(dev, launch_log, spec):
    """The family entry on the card: family_main.main --model rt (full
    widths, float32 by default as the reference codes the legacy family,
    seeded random weights) on a seeded 1080p YUV420 file of
    RT_FAMILY_FRAMES frames, gop 4, 2 rates, run twice with codecs built
    anew: exit code 0 (every frame bit-exact), finite PSNRs, bpp > 0, and
    the second run's .bin bytes and JSON numbers those of the first.
    spec: rt_spec(torch.float32), the launches derived from the models in
    float32 (every DCB plain: none).  Returns the (S = 1, stacked, K2)
    launches derived for it."""
    t0 = time.perf_counter()
    root = scratch_dir("rt_family")
    per_rate = 0
    for i in range(RT_FAMILY_FRAMES):        # gop 4: I P P P I P
        if i % 4 == 0:
            per_rate += spec["encode"] + spec["decode"]
            continue
        for encode in (True, False):
            per_rate += rt_p_launches(spec, i % 4 == 1, encode, True)[0]
    want = (2 * per_rate, 0, 0)             # 2 rates
    try:
        cfg_path, seq = write_cli_inputs(root, dev, RT_FAMILY_FRAMES, 15, 4)
        out = {}
        for run in ("first", "again"):
            argv = ["--model", "rt", "--test_config", cfg_path, "--gop", "4",
                    "--rate_num", "2",
                    "--stream_path", os.path.join(root, run),
                    "--output_path", os.path.join(root, f"{run}.json")]
            code, ms, *got = counted(launch_log, f"RT family_main {run}",
                                     lambda: family_main.main(argv))
            expect(f"RT family_main {run}", tuple(got), want)
            with open(os.path.join(root, f"{run}.json")) as f:
                result = json.load(f)["results"]
            bins = {}
            for name in sorted(os.listdir(os.path.join(root, run))):
                with open(os.path.join(root, run, name), "rb") as f:
                    bins[name] = f.read()
            for rate, r in result["Smoke"][seq].items():
                if code != 0 or not r["bitexact"] or r["frame_type"] != \
                        [0, 1, 1, 1, 0, 1] or not np.isfinite(
                            r["avg_psnr"]) or not r["avg_bpp"] > 0:
                    raise AssertionError(f"RT family_main {run} {rate}: "
                                         f"exit {code}, {r}")
                if run == "first":
                    log(f"RT family_main {rate}: q_index={r['q_index']} "
                        f"bpp={r['avg_bpp']} psnr={r['avg_psnr']} (i "
                        f"{r['avg_psnr_i']} p {r['avg_psnr_p']}) "
                        f"avg_frame_encoding_ms="
                        f"{1e3 * r['avg_frame_encoding_time']} "
                        f"avg_frame_decoding_ms="
                        f"{1e3 * r['avg_frame_decoding_time']}")
            out[run] = (untimed(result), bins, ms)
        if out["first"][:2] != out["again"][:2] or len(out["first"][1]) != 2:
            raise AssertionError("RT family_main: the second run's .bin "
                                 "files or numbers differ from the first's")
        log(f"RT family_main: 2 runs ({out['first'][2]} and "
            f"{out['again'][2]} ms with their codec builds), "
            f"{len(out['first'][1])} .bin files byte-identical, numbers "
            f"equal ({time.perf_counter() - t0:.3f} s)")
    finally:
        shutil.rmtree(root)
    return tuple(2 * n for n in want)       # 2 runs


# ------------------------------------------------ the legacy intra codecs

def legacy_codecs(dev):
    """{name: codec} of LEGACY_CODECS on the card, float32."""
    return {name: cls(lifted_legacy_intra(cls.MODEL_CLS, cfg, seed)
                      .state_dict(), cfg=cfg, device=dev)
            for name, cls, cfg, seed, _ in LEGACY_CODECS}


def phase_stages_legacy(name, codec):
    """The full-width legacy intra model's stages on the card against the
    same model on the CPU, both float32, on a LEGACY_STAGE_SIDE square
    frame: analysis y, the prior's (q_step, scales, means) and spatial's
    (scales, means) on the CPU's z and rounded y, and synthesis of that
    y; z's share of differing symbols is printed.  Fails above
    LEGACY_STAGE_REL_TOL (relative RMS)."""
    gpu, dev = codec.model, codec.device
    cpu = codec.MODEL_CLS(codec.cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    side = LEGACY_STAGE_SIDE
    x = smooth_frame(side, side, 31, torch.device("cpu")) + 0.5
    qs = torch.tensor(0.8)
    out = {}
    with torch.inference_mode():
        for where, model, d in (("cpu", cpu, torch.device("cpu")),
                                ("card", gpu, dev)):
            y, z = model.analysis(x.to(d), qs.to(d))
            if where == "cpu":
                z_cpu, y_hat = z, torch.round(y)
            prior = model.prior(z_cpu.to(d))
            spatial = model.spatial(y_hat.to(d), *prior)
            out[where] = {"analysis y": y, "z": z,
                           **dict(zip(("prior q_step", "prior scales",
                                       "prior means"), prior)),
                           "spatial scales": spatial[0],
                           "spatial means": spatial[1],
                           "synthesis x_hat": model.synthesis(y_hat.to(d),
                                                              qs.to(d))}
    z_diff = (out["card"].pop("z").cpu() != out["cpu"].pop("z")).float()
    errs = {k: rel_rms(out["card"][k], v) for k, v in out["cpu"].items()}
    log(f"{name} stages on the card vs the CPU, float32, {side}x{side}, "
        f"relative RMS (tol {LEGACY_STAGE_REL_TOL}): {json.dumps(errs)}; "
        f"z symbols differing: {z_diff.mean().item()}")
    bad = [k for k, e in errs.items() if not e <= LEGACY_STAGE_REL_TOL]
    if bad:
        raise AssertionError(f"{name} stage outputs disagree with the CPU: "
                             f"{bad}")


def psnr01(x_hat, x):
    """PSNR in dB of a [0, 1] reconstruction against its [0, 1] source."""
    mse = torch.mean((x_hat.float() - x.float()) ** 2).item()
    return 10 * np.log10(1.0 / mse)


def phase_legacy_intra(dev, launch_log, codecs):
    """The legacy intra codecs on the card (LEGACY_CODECS, full published
    widths, float32): at each size and q_scale, encode a seeded frame,
    write the bytes, read them back and decode them: the decoder's x_hat
    equals the encoder's bit for bit, and a second encode gives the same
    bytes.  At 1080p the warm encode and decode of EVC and IntraNoAR are
    timed (median of LEGACY_TIMED calls each, host clock, synchronised:
    an encode ends with the host rANS coder, a decode with its x_hat on
    the card), with bpp and PSNR.  Float32, no K1Block: no launch."""
    t0 = time.perf_counter()
    root = scratch_dir("legacy")
    try:
        for name, _, _, seed, sizes in LEGACY_CODECS:
            codec = codecs[name]
            for h, w in sizes:
                x = smooth_frame(h, w, seed + h, dev) + 0.5
                for qs in LEGACY_Q_SCALES:
                    label = f"legacy {name} {w}x{h} q_scale {qs}"
                    res, enc_ms, *n = counted(
                        launch_log, f"{label} encode",
                        lambda: codec.compress(x, qs))
                    expect(f"{label} encode", tuple(n), NO_LAUNCHES)
                    again, _, *n = counted(launch_log, f"{label} encode 2",
                                           lambda: codec.compress(x, qs))
                    expect(f"{label} encode 2", tuple(n), NO_LAUNCHES)
                    path = os.path.join(root, "frame.bin")
                    with open(path, "wb") as f:
                        f.write(res["bit_stream"])
                    with open(path, "rb") as f:
                        stream = f.read()
                    out, dec_ms, *n = counted(
                        launch_log, f"{label} decode",
                        lambda: codec.decompress(stream, qs, h, w))
                    expect(f"{label} decode", tuple(n), NO_LAUNCHES)
                    if again["bit_stream"] != res["bit_stream"] \
                            or not torch.equal(out["x_hat"], res["x_hat"]) \
                            or out["x_hat"].shape != (1, h, w, 3):
                        raise AssertionError(f"{label}: not bit-exact or "
                                             f"not repeatable")
                    bpp = len(res["bit_stream"]) * 8 / (h * w)
                    log(f"{label}: {len(res['bit_stream'])} bytes, bpp={bpp} "
                        f"psnr={psnr01(out['x_hat'], x)} bit-exact, two "
                        f"encodes equal (cold encode {enc_ms} ms, decode "
                        f"{dec_ms} ms)")
                if h != 1080 or name not in ("EVC", "IntraNoAR"):
                    continue
                qs = LEGACY_Q_SCALES[0]
                times = {"encode": [], "decode": []}
                for _ in range(LEGACY_TIMED):
                    res, ms, *n = counted(launch_log, f"{name} timed encode",
                                          lambda: codec.compress(x, qs))
                    times["encode"].append(ms)
                    expect(f"{name} timed encode", tuple(n), NO_LAUNCHES)
                    out, ms, *n = counted(
                        launch_log, f"{name} timed decode",
                        lambda: codec.decompress(res["bit_stream"], qs, h, w))
                    times["decode"].append(ms)
                    expect(f"{name} timed decode", tuple(n), NO_LAUNCHES)
                log(f"legacy {name} 1920x1080 q_scale {qs} warm: "
                    f"encode_ms={statistics.median(times['encode'])} "
                    f"decode_ms={statistics.median(times['decode'])} "
                    f"(median of {LEGACY_TIMED}: {json.dumps(times)}) "
                    f"bpp={len(res['bit_stream']) * 8 / (h * w)} "
                    f"psnr={psnr01(out['x_hat'], x)}")
    finally:
        shutil.rmtree(root)
    log(f"legacy intra: {len(LEGACY_CODECS)} codecs, every round trip "
        f"bit-exact and repeatable, no kernel launched "
        f"({time.perf_counter() - t0:.3f} s)")


# ---------------------------------------------------------------- DCVC-FM

def phase_stages_fm(codec, name="FM"):
    """DCVC-FM's stages (DCVC-DC's: the same stage methods) at full width
    on the card against the same model on the CPU, both float32, on a
    LEGACY_STAGE_SIDE square pair of
    frames at q_index FM_Q_INDEXES[1]: mv_analysis's mv_y (the first P
    frame's), mc's contexts (from the frame, and from a feature at
    fa_idx 1) on the CPU's mv_hat, ctx_analysis's y on the CPU's
    contexts, and synthesis (x_hat, feature) of the CPU's rounded y; the
    shares of differing mv_z and z symbols are printed.  Fails above
    LEGACY_STAGE_REL_TOL (relative RMS)."""
    gpu, dev = codec.model, codec.device
    cpu = type(gpu)(codec.cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    side, q = LEGACY_STAGE_SIDE, FM_Q_INDEXES[1]
    on_cpu = torch.device("cpu")
    ref, x = [f + 0.5 for f in make_sequence(side, side, 2, 34, on_cpu)]
    feature = torch.rand(1, side, side, codec.cfg.ch_1x,
                         generator=torch.Generator().manual_seed(35))
    out = {}
    with torch.inference_mode():
        for where, model, d in (("cpu", cpu, on_cpu), ("card", gpu, dev)):
            mv_y, mv_z = model.mv_analysis(x.to(d), ref.to(d), None, q)
            if where == "cpu":
                mv_hat = model.mv_synthesis(torch.round(mv_y), q)[0]
            first = model.mc(ref.to(d), None, 0, mv_hat.to(d))
            later = model.mc(ref.to(d), feature.to(d), 1, mv_hat.to(d))
            if where == "cpu":
                ctx = later
            ctx_d = [c.to(d) for c in ctx]
            y, z = model.ctx_analysis(x.to(d), *ctx_d, q)
            if where == "cpu":
                y_hat = torch.round(y)
            x_hat, feat = model.synthesis(y_hat.to(d), *ctx_d, q)
            out[where] = {"mv_z": mv_z, "z": z, "mv_analysis mv_y": mv_y,
                          **{f"mc first c{i + 1}": c
                             for i, c in enumerate(first)},
                          **{f"mc later c{i + 1}": c
                             for i, c in enumerate(later)},
                          "ctx_analysis y": y, "synthesis x_hat": x_hat,
                          "synthesis feature": feat}
    report_stages(name, f"q_index {q}", out)


def report_stages(name, what, out, symbols=("mv_z", "z")):
    """Logs the card-vs-CPU relative RMS of each stage output in
    out[where] and the shares of differing `symbols` (mv_z / z); fails
    above LEGACY_STAGE_REL_TOL."""
    diff = {k: (out["card"].pop(k).cpu() != out["cpu"].pop(k)).float()
            .mean().item() for k in symbols}
    errs = {k: rel_rms(out["card"][k], v) for k, v in out["cpu"].items()}
    side = LEGACY_STAGE_SIDE
    log(f"{name} stages on the card vs the CPU, float32, {side}x{side}, "
        f"{what}, relative RMS (tol {LEGACY_STAGE_REL_TOL}): "
        f"{json.dumps(errs)}; symbols differing: "
        + " ".join(f"{k} {v}" for k, v in diff.items()))
    bad = [k for k, e in errs.items() if not e <= LEGACY_STAGE_REL_TOL]
    if bad:
        raise AssertionError(f"{name} stage outputs disagree with the CPU: "
                             f"{bad}")


def phase_stages_hem(codec):
    """DCVC-HEM's stages at full width on the card against the same model
    on the CPU, both float32, on a LEGACY_STAGE_SIDE square pair of
    frames at the q scales of q index FM_Q_INDEXES[1]: mv_analysis's mv_y,
    mv_prior (zero ref_mv_y) and mv_spatial on the CPU's mv_z and rounded
    mv_y, mc's contexts (from the frame, and from a feature) on the CPU's
    mv_hat, ctx_analysis's y, ctx_prior (a random ref_y) and ctx_spatial,
    and synthesis (y_hat, x_hat, feature) of the CPU's rounded y; the
    shares of differing mv_z and z symbols are printed.  Fails above
    LEGACY_STAGE_REL_TOL (relative RMS)."""
    gpu, dev, cfg = codec.model, codec.device, codec.cfg
    cpu = type(gpu)(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    side, q = LEGACY_STAGE_SIDE, FM_Q_INDEXES[1]
    on_cpu = torch.device("cpu")
    ref, x = [f + 0.5 for f in make_sequence(side, side, 2, 36, on_cpu)]
    gen = torch.Generator().manual_seed(37)
    feature = torch.rand(1, side, side, cfg.ch_n, generator=gen)
    ref_y = torch.randn(1, side // 16, side // 16, cfg.ch_m, generator=gen)
    zeros_mv = torch.zeros(1, side // 16, side // 16, cfg.ch_mv)
    qs_mv, qs_y = (torch.tensor(v) for v in hem_q_scales(q))
    out = {}
    with torch.inference_mode():
        for where, model, d in (("cpu", cpu, on_cpu), ("card", gpu, dev)):
            mv_y, mv_z = model.mv_analysis(x.to(d), ref.to(d), qs_mv.to(d))
            if where == "cpu":
                mv_z_c, mv_y_hat = mv_z, torch.round(mv_y)
            mv_prior = model.mv_prior(mv_z_c.to(d), zeros_mv.to(d))
            mv_sp = model.mv_spatial(mv_y_hat.to(d), *mv_prior)
            if where == "cpu":
                mv_hat = model.mv_synthesis(mv_y_hat, qs_mv)[1]
            first = model.mc(ref.to(d), None, mv_hat.to(d))
            later = model.mc(ref.to(d), feature.to(d), mv_hat.to(d))
            if where == "cpu":
                ctx = later
            ctx_d = [c.to(d) for c in ctx]
            y, z = model.ctx_analysis(x.to(d), *ctx_d, qs_y.to(d))
            if where == "cpu":
                z_c, y_hat = z, torch.round(y)
            prior = model.ctx_prior(z_c.to(d), ctx_d[2], ref_y.to(d))
            sp = model.ctx_spatial(y_hat.to(d), *prior)
            syn = model.synthesis(y_hat.to(d), *ctx_d, qs_y.to(d))
            out[where] = {
                "mv_z": mv_z, "z": z, "mv_analysis mv_y": mv_y,
                **{f"mv_prior {k}": v for k, v in zip(
                    ("q_step", "scales", "means"), mv_prior)},
                "mv_spatial scales": mv_sp[0], "mv_spatial means": mv_sp[1],
                **{f"mc first c{i + 1}": c for i, c in enumerate(first)},
                **{f"mc later c{i + 1}": c for i, c in enumerate(later)},
                "ctx_analysis y": y,
                **{f"ctx_prior {k}": v for k, v in zip(
                    ("q_step", "scales", "means"), prior)},
                "ctx_spatial scales": sp[0], "ctx_spatial means": sp[1],
                **{f"synthesis {k}": v for k, v in zip(
                    ("y_hat", "x_hat", "feature"), syn)}}
    report_stages("HEM", f"q index {q}", out)


def phase_p_frames(name, intra, pcodec, dev, launch_log):
    """A legacy P codec on the card (`name`: FM, HEM or DC; full published
    widths, float32; perf_probe.p_frame_calls: FM's and DC's fa_idx from
    their INDEX_MAPs, HEM's q scales from the family runner's ladders):
    at each size of FM_CASES an intra frame (IntraNoAR) seeds the DPB,
    then at each of FM_Q_INDEXES the P frames are encoded twice from that
    DPB (the same bytes) and decoded from it: every decoder x_hat equals
    the encoder's bit for bit and the final DPBs are equal.  At the first
    size (1080p) the warm encode and decode of the third P frame are timed
    (median of FM_TIMED calls each, host clock, synchronised: an encode
    ends with the host rANS coder, a decode with its x_hat on the card).
    Float32, no K1Block: no launch."""
    t0 = time.perf_counter()
    _, encode_fn, decode_fn, _ = p_frame_calls(name)

    def run(label, fn):
        out, ms, *n = counted(launch_log, label, fn)
        expect(label, tuple(n), NO_LAUNCHES)
        return out, ms

    for h, w, seed, n_p in FM_CASES:
        frames = [f + 0.5 for f in make_sequence(h, w, n_p + 1, seed, dev)]
        seed_frame = run(f"{name} {w}x{h} intra frame",
                         lambda: intra.compress(frames[0], FM_I_Q_SCALE)
                         )[0]["x_hat"]

        def encode(label, q, i):
            return run(f"{label} frame {i} encode",
                       lambda: encode_fn(pcodec, frames[i], i, q))

        def decode(label, q, i, stream):
            return run(f"{label} frame {i} decode",
                       lambda: decode_fn(pcodec, stream, i, q, h, w))

        for q in FM_Q_INDEXES:
            label = f"{name} {w}x{h} q_index {q}"
            passes = []
            for _ in range(2):
                pcodec.set_ref_frame(seed_frame)
                passes.append([encode(label, q, i)[0]
                               for i in range(1, n_p + 1)])
            enc_dpb = dict(pcodec.dpb)
            streams = [r["bit_stream"] for r in passes[0]]
            if [r["bit_stream"] for r in passes[1]] != streams:
                raise AssertionError(f"{label}: two encodes differ")
            pcodec.set_ref_frame(seed_frame)
            for i, res in enumerate(passes[0], 1):
                out = decode(label, q, i, res["bit_stream"])[0]
                if out["x_hat"].shape != (1, h, w, 3) or not torch.equal(
                        out["x_hat"], res["x_hat"]):
                    raise AssertionError(f"{label} frame {i}: the decode "
                                         f"is not bit-exact")
            for k, v in enc_dpb.items():
                if not torch.equal(pcodec.dpb[k], v):
                    raise AssertionError(f"{label}: final DPB {k} differs "
                                         f"between encoder and decoder")
            psnrs = [float(psnr01(r["x_hat"], frames[i]))
                     for i, r in enumerate(passes[0], 1)]
            log(f"{label} ({n_p} P frames): bytes "
                f"{[len(b) for b in streams]}, bpp "
                f"{[len(b) * 8 / (h * w) for b in streams]}, psnr {psnrs}; "
                f"decode bit-exact, final DPB equal, two encodes equal")
        if (h, w) != FM_CASES[0][:2]:
            continue
        q = FM_Q_INDEXES[1]
        label = f"{name} {w}x{h} q_index {q} timed"
        pcodec.set_ref_frame(seed_frame)
        for i in (1, 2):
            encode(label, q, i)
        dpb = dict(pcodec.dpb)
        times = {"encode": [], "decode": []}
        for _ in range(FM_TIMED):
            pcodec.dpb = dict(dpb)
            res, ms = encode(label, q, 3)
            times["encode"].append(ms)
            pcodec.dpb = dict(dpb)
            out, ms = decode(label, q, 3, res["bit_stream"])
            times["decode"].append(ms)
            if not torch.equal(out["x_hat"], res["x_hat"]):
                raise AssertionError(f"{label}: the decode is not bit-exact")
        log(f"{name} {w}x{h} P frame 3 (DPB full) q_index {q} warm: "
            f"encode_ms={statistics.median(times['encode'])} "
            f"decode_ms={statistics.median(times['decode'])} "
            f"(median of {FM_TIMED}: {json.dumps(times)}) "
            f"bpp={len(res['bit_stream']) * 8 / (h * w)} "
            f"psnr={psnr01(out['x_hat'], frames[3])} | {nvidia_smi()}")
    log(f"DCVC-{name}: every P frame bit-exact, final DPBs equal, encodes "
        f"repeatable, no kernel launched "
        f"({time.perf_counter() - t0:.3f} s)")


def phase_fm_family(dev, launch_log):
    """The family entry for DCVC-FM on the card: family_main.main --model
    fm (full widths, float32, seeded random weights at init_scale 0.4 as
    the JAX runner draws them) on a seeded FM_FAMILY_W x FM_FAMILY_H
    YUV420 file of FM_FAMILY_FRAMES frames, gop 4, 2 rates, run twice with
    codecs built anew: exit code 0 (every frame bit-exact), finite PSNRs,
    bpp > 0, the frame types I P P P I P, and the second run's .bin bytes
    and JSON numbers those of the first.  Then once with --fast (the
    estimated-bits mode): exit 0, finite bpp and PSNRs, the same frame
    types.  Float32, no K1Block: no launch."""
    t0 = time.perf_counter()
    root = scratch_dir("fm_family")
    types = [0, 1, 1, 1, 0, 1]
    try:
        cfg_path, seq = write_cli_inputs(root, dev, FM_FAMILY_FRAMES, 16, 4,
                                         FM_FAMILY_H, FM_FAMILY_W)
        out = {}
        for run in ("first", "again", "fast"):
            argv = ["--model", "fm", "--test_config", cfg_path, "--gop", "4",
                    "--rate_num", "2",
                    "--stream_path", os.path.join(root, run),
                    "--output_path", os.path.join(root, f"{run}.json")]
            if run == "fast":
                argv.append("--fast")
            code, ms, *got = counted(launch_log, f"FM family_main {run}",
                                     lambda: family_main.main(argv))
            expect(f"FM family_main {run}", tuple(got), NO_LAUNCHES)
            with open(os.path.join(root, f"{run}.json")) as f:
                result = json.load(f)["results"]
            bins = {}
            for name in sorted(os.listdir(os.path.join(root, run))):
                with open(os.path.join(root, run, name), "rb") as f:
                    bins[name] = f.read()
            for rate, r in result["Smoke"][seq].items():
                if code != 0 or not r["bitexact"] or r["frame_type"] != \
                        types or not np.isfinite(r["avg_psnr"]) or not \
                        np.all(np.isfinite(r["frame_bpp"])) or not \
                        r["avg_bpp"] > 0:
                    raise AssertionError(f"FM family_main {run} {rate}: "
                                         f"exit {code}, {r}")
                if run != "again":
                    log(f"FM family_main {run} {rate}: q_index="
                        f"{r['q_index']} bpp={r['avg_bpp']} frame_bpp="
                        f"{r['frame_bpp']} psnr={r['avg_psnr']} (i "
                        f"{r['avg_psnr_i']} p {r['avg_psnr_p']}) "
                        f"avg_frame_encoding_ms="
                        f"{1e3 * r['avg_frame_encoding_time']} "
                        f"avg_frame_decoding_ms="
                        f"{1e3 * r['avg_frame_decoding_time']}")
            out[run] = (untimed(result), bins, ms)
        if out["first"][:2] != out["again"][:2] or len(out["first"][1]) != 2:
            raise AssertionError("FM family_main: the second run's .bin "
                                 "files or numbers differ from the first's")
        if out["fast"][1]:
            raise AssertionError("FM family_main --fast wrote streams")
        log(f"FM family_main: 2 runs ({out['first'][2]} and "
            f"{out['again'][2]} ms with their codec builds), "
            f"{len(out['first'][1])} .bin files byte-identical, numbers "
            f"equal; --fast {out['fast'][2]} ms "
            f"({time.perf_counter() - t0:.3f} s)")
    finally:
        shutil.rmtree(root)


def phase_family_hem_dc(dev, launch_log):
    """The family entry for DCVC-HEM and DCVC-DC on the card:
    family_main.main --model hem and --model dc (full widths, float32,
    seeded random weights at init_scale 0.4 as the JAX runner draws them)
    on a seeded FM_FAMILY_W x FM_FAMILY_H YUV420 file of HEM_DC_FAMILY_FRAMES
    frames, gop 4, 2 rates: exit code 0 (every frame bit-exact), one
    container file per frame, finite PSNRs, bpp > 0, the frame types I P P
    P.  Then --model hem --fast (the estimated-bits mode): exit 0, finite
    bpp and PSNRs, the same frame types, no stream written.  Float32, no
    K1Block: no launch."""
    t0 = time.perf_counter()
    root = scratch_dir("hem_dc_family")
    n = HEM_DC_FAMILY_FRAMES
    types = [0 if i % 4 == 0 else 1 for i in range(n)]
    try:
        cfg_path, seq = write_cli_inputs(root, dev, n, 17, 4, FM_FAMILY_H,
                                         FM_FAMILY_W)
        for model, fast in (("hem", False), ("dc", False), ("hem", True)):
            run = f"{model}{' fast' if fast else ''}"
            out_dir = os.path.join(root, run.replace(" ", "_"))
            out_json = out_dir + ".json"
            argv = ["--model", model, "--test_config", cfg_path, "--gop",
                    "4", "--rate_num", "2", "--stream_path", out_dir,
                    "--output_path", out_json] + (["--fast"] if fast else [])
            label = f"{model.upper()} family_main{' --fast' if fast else ''}"
            code, ms, *got = counted(launch_log, label,
                                     lambda: family_main.main(argv))
            expect(label, tuple(got), NO_LAUNCHES)
            with open(out_json) as f:
                result = json.load(f)["results"]["Smoke"][seq]
            files = sorted(os.listdir(out_dir))
            if len(files) != (0 if fast else 2 * n):
                raise AssertionError(f"{label}: wrote {files}")
            for rate, r in result.items():
                if code != 0 or not r["bitexact"] or r["frame_type"] != \
                        types or not np.isfinite(r["avg_psnr"]) or not \
                        np.all(np.isfinite(r["frame_bpp"])) or not \
                        r["avg_bpp"] > 0:
                    raise AssertionError(f"{label} {rate}: exit {code}, "
                                         f"{r}")
                log(f"{label} {rate}: q_index={r['q_index']} "
                    f"bpp={r['avg_bpp']} frame_bpp={r['frame_bpp']} "
                    f"psnr={r['avg_psnr']} (i {r['avg_psnr_i']} p "
                    f"{r['avg_psnr_p']}) avg_frame_encoding_ms="
                    f"{1e3 * r['avg_frame_encoding_time']} "
                    f"avg_frame_decoding_ms="
                    f"{1e3 * r['avg_frame_decoding_time']} ({ms} ms with "
                    f"the codec builds)")
        log(f"HEM / DC family_main: every frame bit-exact, one file per "
            f"frame; HEM --fast finite ({time.perf_counter() - t0:.3f} s)")
    finally:
        shutil.rmtree(root)


# -------------------------------- the CompressAI intra codecs, DCVC-2021

COMPRESSAI_CODECS = {"cheng2020": (Cheng2020Codec, CHENG2020_Q1_3),
                     "bmshj2018": (HyperpriorCodec, BMSHJ2018_Q1_5)}


def compressai_codecs(dev):
    """{name: codec} of COMPRESSAI_CODECS on the card, float32, with
    lifted_compressai's weights."""
    return {name: cls(lifted_compressai(name, cfg, COMPRESSAI_SEEDS[name])
                      .state_dict(), cfg=cfg, device=dev)
            for name, (cls, cfg) in COMPRESSAI_CODECS.items()}


def phase_stages_compressai_dcvc(compressai, dcvc):
    """cheng2020's, bmshj2018's and DCVC's stages at full width on the
    card against the same models on the CPU, both float32, on a
    LEGACY_STAGE_SIDE square frame (pair): g_a's y, h_s on the CPU's z_hat,
    g_s on the CPU's rounded y, cheng2020's masked context conv and
    entropy parameters; DCVC's mv_analysis mv_y, mv_prior, mv_synthesis
    (context, temporal prior) on the CPU's rounded mv_y, ctx_analysis y,
    ctx_prior and synthesis on the CPU's latents.  The shares of
    differing z / mv_z symbols are printed.  Fails above
    LEGACY_STAGE_REL_TOL (relative RMS)."""
    side, cpu_dev = LEGACY_STAGE_SIDE, torch.device("cpu")
    ref, x = [f + 0.5 for f in make_sequence(side, side, 2, 73, cpu_dev)]
    with torch.inference_mode():
        for name, codec in compressai.items():
            gpu, dev = codec.model, codec.device
            cpu = type(gpu)(codec.cfg)
            cpu.load_state_dict({k: v.cpu()
                                 for k, v in gpu.state_dict().items()})
            out = {}
            for where, m, d in (("cpu", cpu, cpu_dev), ("card", gpu, dev)):
                y = m.g_a(x.to(d))
                z = m.h_a(y)
                if where == "cpu":
                    z_hat, y_hat = torch.round(z), torch.round(y)
                stages = {"g_a y": y, "h_s": m.h_s(z_hat.to(d)),
                          "g_s x_hat": m.g_s(y_hat.to(d)),
                          "z": torch.round(z)}
                if name == "cheng2020":
                    ctx = m._masked_conv(y_hat.to(d))
                    stages["context"] = ctx
                    stages["entropy_parameters"] = m.entropy_parameters(
                        torch.cat([stages["h_s"], ctx], dim=-1))
                out[where] = stages
            report_stages(name, "image", out, ("z",))
        gpu, dev, cfg = dcvc.model, dcvc.device, dcvc.cfg
        cpu = type(gpu)(cfg)
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        out = {}
        for where, m, d in (("cpu", cpu, cpu_dev), ("card", gpu, dev)):
            mv_y, mv_z = m.mv_analysis(x.to(d), ref.to(d))
            if where == "cpu":
                mv_z_c, mv_y_hat = mv_z, torch.round(mv_y)
            context, temporal = m.mv_synthesis(mv_y_hat.to(d), ref.to(d))
            if where == "cpu":
                ctx_c = context
            y, z = m.ctx_analysis(x.to(d), ctx_c.to(d))
            if where == "cpu":
                z_c, y_hat = z, torch.round(y)
            out[where] = {"mv_z": mv_z, "z": z, "mv_analysis mv_y": mv_y,
                          "mv_prior": m.mv_prior(mv_z_c.to(d)),
                          "mv_synthesis context": context,
                          "mv_synthesis temporal": temporal,
                          "ctx_analysis y": y,
                          "ctx_prior": m.ctx_prior(z_c.to(d)),
                          "synthesis x_hat": m.synthesis(y_hat.to(d),
                                                         ctx_c.to(d))}
        report_stages("DCVC", "P frame", out)


class HostClock:
    """Inside, the host AR loops' encode / decode and the host rANS
    coders' calls of `codecs` are timed: ar_ms (the AR loops, less the
    rANS calls they make), rans_ms (every rANS call), positions (latent
    positions the AR loops visited)."""

    RANS = ("encode_with_indexes", "flush", "get_encoded_stream",
            "set_stream", "decode_stream")

    def __init__(self, codecs):
        self.codecs = codecs
        self.ar_ms = self.rans_ms = self._in_ar_rans = 0.0
        self.positions = 0
        self._depth = 0

    def _wrap(self, obj, name, kind):
        fn = getattr(obj, name)

        def timed(*args):
            t0 = time.perf_counter()
            if kind == "ar":
                self._depth += 1
                self.positions += args[0].shape[0] * args[0].shape[1]
            try:
                return fn(*args)
            finally:
                ms = 1e3 * (time.perf_counter() - t0)
                if kind == "ar":
                    self._depth -= 1
                    self.ar_ms += ms
                else:
                    self.rans_ms += ms
                    if self._depth:
                        self._in_ar_rans += ms
        setattr(obj, name, timed)
        self._saved.append((obj, name))

    def __enter__(self):
        self._saved = []
        for c in self.codecs:
            for ar in [getattr(c, a) for a in ("ar", "ar_y", "ar_mv")
                       if hasattr(c, a)]:
                self._wrap(ar, "encode", "ar")
                self._wrap(ar, "decode", "ar")
            for coder in (c.encoder, c.decoder):
                for name in self.RANS:
                    if hasattr(coder, name):
                        self._wrap(coder, name, "rans")
        return self

    def __exit__(self, *exc):
        for obj, name in self._saved:
            delattr(obj, name)
        self.ar_ms -= self._in_ar_rans

    def line(self, wall_ms):
        """The split of a call of wall_ms: device stages and glue (the
        rest), host AR, host rANS."""
        per = 1e3 * self.ar_ms / max(self.positions, 1)
        return (f"wall_ms={wall_ms} host_ar_ms={self.ar_ms} "
                f"(positions={self.positions}, us_per_position={per}) "
                f"host_rans_ms={self.rans_ms} device_and_glue_ms="
                f"{wall_ms - self.ar_ms - self.rans_ms}")


def phase_compressai_dcvc(dev, launch_log, compressai, dcvc):
    """The CompressAI intra codecs and DCVC-2021 on the card (full
    published widths, float32): cheng2020 and bmshj2018 encode a seeded
    1080p image and decode it (the decoder's x_hat equal to the encoder's
    bit for bit); then DCVC_P_FRAMES DCVC P frames at 1080p from
    cheng2020's reconstruction, encoded and decoded from the same
    reference (every x_hat and the final reference frame bit for bit).
    Each call's wall time is split (HostClock) into the host AR loop (and
    its us per latent position), the host rANS coder, and the rest (the
    device stages and glue).  Float32, no K1Block: no launch."""
    t0 = time.perf_counter()
    h, w, seed = DCVC_CASE
    frames = [f + 0.5 for f in make_sequence(h, w, DCVC_P_FRAMES + 1, seed,
                                             dev)]

    def run(label, codec, fn):
        with HostClock([codec]) as clock:
            out, ms, *n = counted(launch_log, label, fn)
        expect(label, tuple(n), NO_LAUNCHES)
        log(f"{label}: {clock.line(ms)}")
        return out

    seed_frame = None
    for name, codec in compressai.items():
        res = run(f"{name} {w}x{h} encode", codec,
                  lambda: codec.compress(frames[0]))
        out = run(f"{name} {w}x{h} decode", codec,
                  lambda: codec.decompress(res["y_string"], res["z_string"],
                                           h, w))
        if out["x_hat"].shape != (1, h, w, 3) or not torch.equal(
                out["x_hat"], res["x_hat"]):
            raise AssertionError(f"{name} {w}x{h}: the decode is not "
                                 f"bit-exact")
        n_bytes = len(res["y_string"]) + len(res["z_string"])
        log(f"{name} {w}x{h}: bytes={n_bytes} bpp={n_bytes * 8 / (h * w)} "
            f"psnr={psnr01(res['x_hat'], frames[0])}; decode bit-exact | "
            f"{nvidia_smi()}")
        if name == "cheng2020":
            seed_frame = res["x_hat"]
    dcvc.set_ref_frame(seed_frame)
    encoded = [run(f"DCVC {w}x{h} P frame {i} encode", dcvc,
                   lambda i=i: dcvc.compress(frames[i]))
               for i in range(1, DCVC_P_FRAMES + 1)]
    enc_ref = dcvc.ref_frame
    dcvc.set_ref_frame(seed_frame)
    strings = ("mv_y_string", "mv_z_string", "y_string", "z_string")
    for i, res in enumerate(encoded, 1):
        out = run(f"DCVC {w}x{h} P frame {i} decode", dcvc,
                  lambda res=res: dcvc.decompress(
                      *[res[k] for k in strings], h, w))
        if not torch.equal(out["x_hat"], res["x_hat"]):
            raise AssertionError(f"DCVC {w}x{h} P frame {i}: the decode is "
                                 f"not bit-exact")
    if not torch.equal(dcvc.ref_frame, enc_ref):
        raise AssertionError("DCVC: the final reference frames differ")
    sizes = [[len(r[k]) for k in strings] for r in encoded]
    log(f"DCVC {w}x{h} ({DCVC_P_FRAMES} P frames): bytes (mv_y, mv_z, y, z) "
        f"{sizes}, bpp {[sum(b) * 8 / (h * w) for b in sizes]}, psnr "
        f"{[psnr01(r['x_hat'], frames[i]) for i, r in enumerate(encoded, 1)]}"
        f"; every decode bit-exact, final reference equal")
    log(f"CompressAI / DCVC-2021: bit-exact, no kernel launched "
        f"({time.perf_counter() - t0:.3f} s)")


def phase_family_dcvc(dev, launch_log):
    """The family entry for DCVC-2021 on the card: family_main.main --model
    dcvc (cheng2020 at CHENG2020_Q1_3 and DCVC at DCVC_CONFIG, float32,
    seeded random weights as the JAX runner draws them: P at init_scale
    0.4) on a seeded FM_FAMILY_W x FM_FAMILY_H YUV420 file of
    DCVC_FAMILY_FRAMES frames, gop 4, one rate: exit code 0 (every frame
    bit-exact), one container file per frame, finite PSNRs, bpp > 0, the
    frame types I P P P.  Then --fast: exit 0, finite bpp and PSNRs, no
    stream written.  Float32, no K1Block: no launch."""
    t0 = time.perf_counter()
    root = scratch_dir("dcvc_family")
    n = DCVC_FAMILY_FRAMES
    types = [0 if i % 4 == 0 else 1 for i in range(n)]
    try:
        cfg_path, seq = write_cli_inputs(root, dev, n, 18, 4, FM_FAMILY_H,
                                         FM_FAMILY_W)
        for fast in (False, True):
            out_dir = os.path.join(root, "fast" if fast else "coded")
            out_json = out_dir + ".json"
            argv = ["--model", "dcvc", "--test_config", cfg_path, "--gop",
                    "4", "--rate_num", "1", "--stream_path", out_dir,
                    "--output_path", out_json] + (["--fast"] if fast else [])
            label = f"DCVC family_main{' --fast' if fast else ''}"
            code, ms, *got = counted(launch_log, label,
                                     lambda: family_main.main(argv))
            expect(label, tuple(got), NO_LAUNCHES)
            with open(out_json) as f:
                result = json.load(f)["results"]["Smoke"][seq]
            files = sorted(os.listdir(out_dir))
            if len(files) != (0 if fast else n):
                raise AssertionError(f"{label}: wrote {files}")
            for rate, r in result.items():
                if code != 0 or not r["bitexact"] or r["frame_type"] != \
                        types or not np.isfinite(r["avg_psnr"]) or not \
                        np.all(np.isfinite(r["frame_bpp"])) or not \
                        r["avg_bpp"] > 0:
                    raise AssertionError(f"{label} {rate}: exit {code}, "
                                         f"{r}")
                log(f"{label} {rate}: q_index={r['q_index']} "
                    f"bpp={r['avg_bpp']} frame_bpp={r['frame_bpp']} "
                    f"psnr={r['avg_psnr']} (i {r['avg_psnr_i']} p "
                    f"{r['avg_psnr_p']}) avg_frame_encoding_ms="
                    f"{1e3 * r['avg_frame_encoding_time']} "
                    f"avg_frame_decoding_ms="
                    f"{1e3 * r['avg_frame_decoding_time']} ({ms} ms with "
                    f"the codec builds)")
        log(f"DCVC family_main: every frame bit-exact, one file per frame; "
            f"--fast finite ({time.perf_counter() - t0:.3f} s)")
    finally:
        shutil.rmtree(root)


# ------------------------------------------------------------------ DCVC-TCM

def phase_stages_tcm(codec):
    """DCVC-TCM's stages at full width on the card against the same model
    on the CPU, both float32, on a LEGACY_STAGE_SIDE square pair of
    frames: mv_analysis's mv_y, mv_prior and mv_synthesis on the CPU's
    mv_z and rounded mv_y, mc's contexts (from the frame, and from a
    feature) on the CPU's mv_hat, ctx_analysis's y, ctx_prior and
    synthesis (x_hat, feature) on the CPU's z, contexts and rounded y.
    Fails above LEGACY_STAGE_REL_TOL (relative RMS) or if a mv_z or z
    symbol differs."""
    gpu, dev, cfg = codec.model, codec.device, codec.cfg
    cpu = DMCTCM(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    side, on_cpu = LEGACY_STAGE_SIDE, torch.device("cpu")
    ref, x = [f + 0.5 for f in make_sequence(side, side, 2, 83, on_cpu)]
    feature = torch.rand(1, side, side, cfg.ch_n,
                         generator=torch.Generator().manual_seed(84))
    out = {}
    with torch.inference_mode():
        for where, m, d in (("cpu", cpu, on_cpu), ("card", gpu, dev)):
            mv_y, mv_z = m.mv_analysis(x.to(d), ref.to(d))
            if where == "cpu":
                mv_z_c, mv_y_hat = mv_z, torch.round(mv_y)
            mv_prior = m.mv_prior(mv_z_c.to(d))
            mv_hat = m.mv_synthesis(mv_y_hat.to(d))
            if where == "cpu":
                mv_hat_c = mv_hat
            first = m.mc(ref.to(d), None, mv_hat_c.to(d))
            later = m.mc(ref.to(d), feature.to(d), mv_hat_c.to(d))
            if where == "cpu":
                ctx = later
            ctx_d = [c.to(d) for c in ctx]
            y, z = m.ctx_analysis(x.to(d), *ctx_d)
            if where == "cpu":
                z_c, y_hat = z, torch.round(y)
            prior = m.ctx_prior(z_c.to(d), *ctx_d)
            syn = m.synthesis(y_hat.to(d), *ctx_d)
            out[where] = {
                "mv_z": mv_z, "z": z, "mv_analysis mv_y": mv_y,
                "mv_prior scales": mv_prior[0], "mv_prior means": mv_prior[1],
                "mv_synthesis mv_hat": mv_hat,
                **{f"mc first c{i + 1}": c for i, c in enumerate(first)},
                **{f"mc later c{i + 1}": c for i, c in enumerate(later)},
                "ctx_analysis y": y, "ctx_prior scales": prior[0],
                "ctx_prior means": prior[1], "synthesis x_hat": syn[0],
                "synthesis feature": syn[1]}
    differ = {k: int((out["card"][k].cpu() != out["cpu"][k]).sum())
              for k in ("mv_z", "z")}
    report_stages("TCM", "P frame", out)
    if any(differ.values()):
        raise AssertionError(f"TCM: symbols differ between the card and "
                             f"the CPU: {differ}")


def phase_tcm(dev, launch_log, intra, pcodec):
    """DCVC-TCM on the card (TCM_CONFIG, float32, TF32 off; lifted_tcm's
    weights): at each size of TCM_CASES an intra frame of `intra` (the
    bmshj2018 codec) seeds the DPB, then the P frames are encoded twice
    from it (the same bytes) and decoded from it: every decoder x_hat
    equals the encoder's bit for bit and the final DPBs (frame and
    feature) are equal.  At 1080p the warm encode and decode of the third
    P frame (the DPB holding a feature) are timed (median of TCM_TIMED
    calls each, host clock, synchronised), each split into the host rANS
    coder and the rest (device stages and glue).  Float32, no K1Block: no
    launch."""
    t0 = time.perf_counter()

    def run(label, fn):
        with HostClock([pcodec]) as clock:
            out, ms, *n = counted(launch_log, label, fn)
        expect(label, tuple(n), NO_LAUNCHES)
        return out, ms, clock.rans_ms

    for h, w, seed, n_p in TCM_CASES:
        frames = [f + 0.5 for f in make_sequence(h, w, n_p + 1, seed, dev)]
        label = f"TCM {w}x{h}"
        seed_frame = run(f"{label} intra frame",
                         lambda: intra.compress(frames[0]))[0]["x_hat"]

        def encode(i):
            return run(f"{label} P frame {i} encode",
                       lambda: pcodec.compress(frames[i]))

        def decode(i, stream):
            return run(f"{label} P frame {i} decode",
                       lambda: pcodec.decompress(stream, h, w))

        passes = []
        for _ in range(2):
            pcodec.set_ref_frame(seed_frame)
            passes.append([encode(i)[0] for i in range(1, n_p + 1)])
        enc_dpb = pcodec.dpb
        streams = [r["bit_stream"] for r in passes[0]]
        if [r["bit_stream"] for r in passes[1]] != streams:
            raise AssertionError(f"{label}: two encodes differ")
        pcodec.set_ref_frame(seed_frame)
        for i, res in enumerate(passes[0], 1):
            out = decode(i, res["bit_stream"])[0]
            if out["x_hat"].shape != (1, h, w, 3) or not torch.equal(
                    out["x_hat"], res["x_hat"]):
                raise AssertionError(f"{label} P frame {i}: the decode is "
                                     f"not bit-exact")
        for k, v in enc_dpb.items():
            if not torch.equal(pcodec.dpb[k], v):
                raise AssertionError(f"{label}: final DPB {k} differs "
                                     f"between encoder and decoder")
        psnrs = [float(psnr01(r["x_hat"], frames[i]))
                 for i, r in enumerate(passes[0], 1)]
        log(f"{label} ({n_p} P frames): bytes {[len(b) for b in streams]}, "
            f"bpp {[len(b) * 8 / (h * w) for b in streams]}, psnr {psnrs}; "
            f"decode bit-exact, final DPB equal, two encodes equal")
        if (h, w) != TCM_CASES[0][:2]:
            continue
        pcodec.set_ref_frame(seed_frame)
        for i in (1, 2):
            encode(i)
        dpb = pcodec.dpb
        times = {"encode": [], "decode": []}
        rans = {"encode": [], "decode": []}
        for _ in range(TCM_TIMED):
            pcodec.dpb = dpb
            res, ms, r_ms = encode(3)
            times["encode"].append(ms)
            rans["encode"].append(r_ms)
            pcodec.dpb = dpb
            out, ms, r_ms = decode(3, res["bit_stream"])
            times["decode"].append(ms)
            rans["decode"].append(r_ms)
            if not torch.equal(out["x_hat"], res["x_hat"]):
                raise AssertionError(f"{label}: the decode is not bit-exact")
        med = {k: statistics.median(v) for k, v in times.items()}
        med_rans = {k: statistics.median(v) for k, v in rans.items()}
        log(f"TCM {w}x{h} P frame 3 (feature in the DPB) warm: "
            f"encode_ms={med['encode']} (host_rans_ms={med_rans['encode']}"
            f", rest_ms={med['encode'] - med_rans['encode']}) "
            f"decode_ms={med['decode']} (host_rans_ms={med_rans['decode']}"
            f", rest_ms={med['decode'] - med_rans['decode']}) "
            f"(median of {TCM_TIMED}: {json.dumps(times)}, host rANS "
            f"{json.dumps(rans)}) bpp={len(res['bit_stream']) * 8 / (h * w)}"
            f" psnr={psnr01(out['x_hat'], frames[3])} | {nvidia_smi()}")
    log(f"DCVC-TCM: every P frame bit-exact, final DPBs equal, encodes "
        f"repeatable, no kernel launched ({time.perf_counter() - t0:.3f} s)")


def phase_family_tcm(dev, launch_log):
    """The family entry for DCVC-TCM and the reference-checkpoint
    converter on the card: family_main.main --model tcm (bmshj2018 at
    HyperpriorConfig() and TCM at TCM_CONFIG, float32, seeded random
    weights as the JAX runner draws them: P at init_scale 0.4) on a
    seeded FM_FAMILY_W x FM_FAMILY_H YUV420 file of TCM_FAMILY_FRAMES
    frames, gop 4, one rate: exit code 0 (every frame bit-exact), one file
    per frame, finite PSNRs, bpp > 0, the frame types I P P P.  Then
    --fast: exit 0, finite bpp and PSNRs, no stream written.  Then the
    converter: the runner's own P model (FamilyRunner("tcm")'s, in
    memory) written as a reference .pth.tar by save_reference, turned
    into params.v1 by import_cli.main, and family_main --model_path_p on
    it: the same .bin bytes and numbers as the first run.  Float32, no
    K1Block: no launch."""
    t0 = time.perf_counter()
    root = scratch_dir("tcm_family")
    n = TCM_FAMILY_FRAMES
    types = [0 if i % 4 == 0 else 1 for i in range(n)]
    try:
        cfg_path, seq = write_cli_inputs(root, dev, n, 19, 4, FM_FAMILY_H,
                                         FM_FAMILY_W)
        runner = family.FamilyRunner("tcm", os.path.join(root, "unused"),
                                     device=dev)
        pth = os.path.join(root, "tcm_p.pth.tar")
        save_reference(pth, runner.p_codec.model)
        del runner
        converted = os.path.join(root, "tcm_p.bin")
        if import_cli.main([pth, converted, "--kind", "tcm"]) != 0:
            raise AssertionError("import_cli: non-zero exit")
        out = {}
        for run in ("coded", "fast", "converted"):
            fast = run == "fast"
            out_dir = os.path.join(root, run)
            out_json = out_dir + ".json"
            argv = ["--model", "tcm", "--test_config", cfg_path, "--gop",
                    "4", "--rate_num", "1", "--stream_path", out_dir,
                    "--output_path", out_json] + (["--fast"] if fast else [])
            if run == "converted":
                argv += ["--model_path_p", converted]
            label = f"TCM family_main {run}"
            code, ms, *got = counted(launch_log, label,
                                     lambda: family_main.main(argv))
            expect(label, tuple(got), NO_LAUNCHES)
            with open(out_json) as f:
                results = json.load(f)["results"]
            result = results["Smoke"][seq]
            bins = {}
            for name in sorted(os.listdir(out_dir)):
                with open(os.path.join(out_dir, name), "rb") as f:
                    bins[name] = f.read()
            if len(bins) != (0 if fast else n):
                raise AssertionError(f"{label}: wrote {sorted(bins)}")
            for rate, r in result.items():
                if code != 0 or not r["bitexact"] or r["frame_type"] != \
                        types or not np.isfinite(r["avg_psnr"]) or not \
                        np.all(np.isfinite(r["frame_bpp"])) or not \
                        r["avg_bpp"] > 0:
                    raise AssertionError(f"{label} {rate}: exit {code}, "
                                         f"{r}")
                log(f"{label} {rate}: q_index={r['q_index']} "
                    f"bpp={r['avg_bpp']} frame_bpp={r['frame_bpp']} "
                    f"psnr={r['avg_psnr']} (i {r['avg_psnr_i']} p "
                    f"{r['avg_psnr_p']}) avg_frame_encoding_ms="
                    f"{1e3 * r['avg_frame_encoding_time']} "
                    f"avg_frame_decoding_ms="
                    f"{1e3 * r['avg_frame_decoding_time']} ({ms} ms with "
                    f"the codec builds)")
            out[run] = (untimed(results), bins)
        if out["converted"] != out["coded"]:
            raise AssertionError("TCM family_main --model_path_p (the "
                                 "converted reference checkpoint): the .bin "
                                 "files or numbers differ from the model in "
                                 "memory's")
        log(f"TCM family_main: every frame bit-exact, one file per frame; "
            f"--fast finite; save_reference -> import_cli -> --model_path_p "
            f"codes the same {n} .bin files ({time.perf_counter() - t0:.3f} "
            f"s)")
    finally:
        shutil.rmtree(root)


def write_cli_inputs(root, dev, frames=CLI_FRAMES, seed=8,
                     intra_period=-1, h=CLI_H, w=CLI_W):
    """A seeded YUV420 file of `frames` w x h frames (the drifting
    picture of make_sequence, read as YCbCr, chroma 2x2-averaged) and a
    test_config naming it, under `root`.  Returns (config path, sequence
    name)."""
    seq = f"smoke_{w}x{h}_30.yuv"
    os.makedirs(os.path.join(root, "Smoke"))
    with open(os.path.join(root, "Smoke", seq), "wb") as f:
        for frame in make_sequence(h, w, frames, seed, dev):
            yuv = torch.round((frame[0] + 0.5) * 255)
            uv = yuv[..., 1:].reshape(h // 2, 2, w // 2, 2, 2).mean(
                (1, 3)).round().permute(2, 0, 1)
            f.write(yuv[..., 0].to(torch.uint8).cpu().numpy().tobytes())
            f.write(uv.to(torch.uint8).cpu().numpy().tobytes())
    cfg = {"root_path": root, "test_classes": {"Smoke": {
        "test": 1, "base_path": "Smoke", "src_type": "yuv420",
        "sequences": {seq: {"width": w, "height": h,
                            "frames": frames,
                            "intra_period": intra_period}}}}}
    path = os.path.join(root, "test_config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, seq


def cli_launches(spec, point, device_ec=False):
    """(S = 1, stacked, K2) launches of one point of the harness on a
    sequence with one intra frame (intra_period -1): its frame walk
    (run_one_point_with_stream), each P unit encoded without and decoded
    with the recon head."""
    fd = spec["cfg"].frame_delay
    total = [ENCODE_LAUNCHES + DECODE_LAUNCHES, 0,
             DMCI_K2_LAUNCHES if device_ec else 0]
    idx, first = 1, True
    while idx < point["frame_num"]:
        reset = (point["reset_interval"] > 0
                 and (idx + fd) % point["reset_interval"] == 1)
        for encode in (True, False):
            got = unit_launches(spec, first, reset, encode, not encode)
            total[0] += got[0]
            total[1] += got[1]
        total[2] += spec["k2"] if device_ec else 0
        first, idx = reset, idx + fd
    return tuple(total)


def write_png_inputs(root, dev, frames=PNG_FRAMES, seed=9):
    """A seeded numbered-PNG sequence of `frames` CLI_W x CLI_H frames (the
    drifting picture of make_sequence, read as RGB), written by
    utils/png.py, and a test_config naming it (src_type png, one intra
    frame), under `root`.  Returns (config path, sequence name, the
    frames' paths)."""
    seq = f"smoke_png_{CLI_W}x{CLI_H}"
    folder = os.path.join(root, "SmokePNG", seq)
    os.makedirs(folder)
    paths = []
    for i, frame in enumerate(make_sequence(CLI_H, CLI_W, frames, seed,
                                            dev)):
        paths.append(os.path.join(folder, f"im{i + 1:05d}.png"))
        write_png(paths[-1], torch.round((frame[0] + 0.5) * 255).to(
            torch.uint8).cpu().numpy())
    cfg = {"root_path": root, "test_classes": {"SmokePNG": {
        "test": 1, "base_path": "SmokePNG", "src_type": "png",
        "sequences": {seq: {"width": CLI_W, "height": CLI_H,
                            "frames": frames, "intra_period": -1}}}}}
    path = os.path.join(root, "test_config_png.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, seq, paths


def check_point(tag, res, frames=CLI_FRAMES):
    """A point's result: every frame coded, finite PSNR, bpp > 0."""
    coded = res["i_frame_num"] + res["p_frame_num"]
    if coded != frames or not np.isfinite(res["ave_all_frame_psnr"]) \
            or not res["ave_all_frame_bpp"] > 0:
        raise AssertionError(f"{tag}: {coded} frames, psnr "
                             f"{res['ave_all_frame_psnr']}, bpp "
                             f"{res['ave_all_frame_bpp']}")


def phase_cli(dev, launch_log):
    """The evaluation entry on the card: a seeded 1080p YUV420 file and a
    test_config in a temporary directory of the checkout;
    video_main.main run in-process with --model_structure ld, hts, and ld
    at --rate_num 2 (random weights, --verbose 1: the harness prints its
    average times after the 4 warm-up frames), every point's JSON
    checked.  Then the first point again through
    run_one_point_with_stream, with codecs built anew: the same .bin
    bytes, and with device_ec=True (K2) the same bits and PSNRs per
    frame.  Last, a seeded sequence of PNG_FRAMES 1080p PNGs through
    video_main --model_structure ld --save_decoded_frame 1 (this machine
    has no PIL): the point checked, and the decoded PNG files read back
    give the harness's PSNR per frame.  Its K2 calls are not replayed.
    Returns the (S = 1, stacked, K2) launches derived for it, each call's
    checked."""
    derived = [0, 0, 0]
    root = tempfile.mkdtemp(prefix="_smoke_cli_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        cfg_path, seq = write_cli_inputs(root, dev)

        def argv(structure, out, *extra):
            return ["--test_config", cfg_path, "--model_structure", structure,
                    "--output_path", os.path.join(root, f"{out}.json"),
                    "--stream_path", os.path.join(root, out),
                    "--verbose", "1", *extra]
        one_rate = ("--rate_num", "1", "--qp_i", "32", "--qp_p", "32")
        runs = [("LD", "qp 32", argv("ld", "ld", *one_rate)),
                ("HTS", "qp 32", argv("hts", "hts", *one_rate)),
                ("LD", "rate_num 2", argv("ld", "ld_rates", "--rate_num",
                                          "2"))]
        for name, rates, args in runs:
            label = f"CLI {name} {rates}"
            result, ms, n1, ns, n2 = counted(
                launch_log, label, lambda: video_main.main(args))
            points = video_main.build_points(
                video_main.parse_args(args), DMCIConfig().qp_num)[0]
            want = [0, 0, 0]
            for point in points:
                for i, n in enumerate(cli_launches(VIDEO[name], point)):
                    want[i] += n
            expect(label, (n1, ns, n2), tuple(want))
            for i in range(3):
                derived[i] += want[i]
            for idx, res in result["Smoke"][seq].items():
                check_point(f"{label} rate {idx}", res)
                # the harness times the coded units after its 4 warm-up
                # ones; an HTS point at 10 frames has 3 units
                times = ("avg_frame_encoding_ms="
                         f"{1e3 * res['avg_frame_encoding_time']} "
                         "avg_frame_decoding_ms="
                         f"{1e3 * res['avg_frame_decoding_time']}"
                         if "avg_frame_encoding_time" in res
                         else "times not kept (4 or fewer coded units)")
                log(f"{label} rate {idx}: bpp={res['ave_all_frame_bpp']} "
                    f"psnr={res['ave_all_frame_psnr']} {times} (CLI run "
                    f"{ms} ms with its codec builds)")

        args = video_main.parse_args(runs[0][2])
        point = dict(video_main.build_points(args, DMCIConfig().qp_num)[0][0],
                     verbose_json=True)
        with open(point["curr_bin_path"], "rb") as f:
            first_bin = f.read()
        again = []
        for device_ec in (False, True):
            codecs = video_main.build_codecs(args, device_ec)
            bin_path = os.path.join(root, f"again_{int(device_ec)}.bin")
            pt = dict(point, curr_bin_path=bin_path,
                      curr_json_path=bin_path.replace(".bin", ".json"))
            label = f"CLI LD point again, device_ec={device_ec}"
            res, ms, n1, ns, n2 = counted(
                launch_log, label,
                lambda: run_one_point_with_stream(codecs[1], codecs[0],
                                                  codecs[2], pt))
            want = cli_launches(VIDEO["LD"], pt, device_ec)
            expect(label, (n1, ns, n2), want)
            for i in range(3):
                derived[i] += want[i]
            with open(bin_path, "rb") as f:
                if f.read() != first_bin:
                    raise AssertionError(f"{label}: the .bin differs from "
                                         f"the first run's")
            check_point(label, res)
            again.append(res)
        host, device = again
        if host["frame_bpp"] != device["frame_bpp"] \
                or host["frame_psnr"] != device["frame_psnr"]:
            raise AssertionError("CLI LD point: the device decode's bits or "
                                 "PSNRs differ from the host decode's")
        log(f"CLI: {len(runs)} runs of video_main.main, every point "
            f"checked; the first point again: .bin byte-identical, host and "
            f"device (K2) decodes equal in bits and PSNR per frame "
            f"({len(host['frame_psnr'])} frames)")

        # a PNG source, read and written without PIL (utils/png_frames.py)
        png_cfg, png_seq, sources = write_png_inputs(root, dev)
        args = ["--test_config", png_cfg, "--model_structure", "ld",
                "--output_path", os.path.join(root, "png.json"),
                "--stream_path", os.path.join(root, "png_out"),
                "--save_decoded_frame", "1", "--verbose_json", "1",
                *one_rate]
        label = "CLI LD png source"
        result, ms, *n = counted(launch_log, label,
                                 lambda: video_main.main(args))
        point = video_main.build_points(video_main.parse_args(args),
                                        DMCIConfig().qp_num)[0][0]
        want = cli_launches(VIDEO["LD"], point)
        expect(label, tuple(n), want)
        for i in range(3):
            derived[i] += want[i]
        res = result["SmokePNG"][png_seq]["000"]
        check_point(label, res, PNG_FRAMES)
        decoded = sorted(f for f in os.listdir(point["bin_folder"])
                         if f.endswith(".png"))
        if decoded != [os.path.basename(p) for p in sources]:
            raise AssertionError(f"{label}: decoded frames {decoded}")
        psnrs = []
        for name, src in zip(decoded, sources):
            rec = load_rgb(os.path.join(point["bin_folder"], name))
            psnrs.append(calc_psnr(load_rgb(src).astype(np.float64),
                                   rec.astype(np.float64)))
        if not np.allclose(psnrs, res["frame_psnr"], rtol=0, atol=1e-9):
            raise AssertionError(f"{label}: the decoded PNGs' PSNRs {psnrs} "
                                 f"differ from the harness's "
                                 f"{res['frame_psnr']}")
        log(f"{label}: {PNG_FRAMES} frames of {CLI_W}x{CLI_H} PNGs, "
            f"bpp={res['ave_all_frame_bpp']} psnr={res['ave_all_frame_psnr']}"
            f"; the decoded PNGs (--save_decoded_frame) give the harness's "
            f"PSNR per frame (run {ms} ms with its codec builds)")
    finally:
        shutil.rmtree(root)
    return tuple(derived)


# ------------------------------------------------- the evaluation surface

def scratch_dir(kind):
    """A temporary directory of the checkout (gitignored: _smoke_*)."""
    return tempfile.mkdtemp(prefix=f"_smoke_{kind}_",
                            dir=os.path.dirname(os.path.abspath(__file__)))


def seeded_model(codec_cls, cfg, init_scale=1.0):
    """The float32 model that codec_cls.init_random(seed 0, cfg,
    init_scale) starts from, on the CPU."""
    model = DMCI(cfg) if codec_cls is DMCICodec else codec_cls.MODEL(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if init_scale != 1.0 and codec_cls._damped(name):
                p.mul_(init_scale)
    return model


def phase_params_v1(dmci, hts, dev, launch_log):
    """dcvc_tpu.params.v1 at full width: the float32 models of the main
    path's DMCI (DMCIConfig()) and HTS (HTS_CONFIG, init_scale 0.5)
    codecs written by save_native and read back by load_native_into into
    fresh models at the headers' configs; codecs on them (bf16, skip
    0.15) code a 1080p DMCI frame and, seeded by it, an HTS chunk to the
    in-memory codecs' bytes, with equal x_hat and a bit-exact DPB.
    Returns the (S = 1, stacked, K2) launches derived for it."""
    t0 = time.perf_counter()
    root = scratch_dir("ckpt")
    try:
        paths = {"DMCI": os.path.join(root, "dmci.bin"),
                 "HTS": os.path.join(root, "hts.bin")}
        save_native(seeded_model(DMCICodec, DMCIConfig()), paths["DMCI"])
        save_native(seeded_model(DMCHTCodec, HTS_CONFIG, 0.5), paths["HTS"])
        i_cfg = native_config(paths["DMCI"], DMCIConfig, None)
        p_cfg = native_config(paths["HTS"], DMCHTConfig, None)
        if i_cfg != DMCIConfig() or p_cfg != HTS_CONFIG:
            raise AssertionError(f"params.v1 headers: {i_cfg}, {p_cfg}")
        kw = {"dtype": torch.bfloat16, "device": dev, "skip_thres": 0.15}
        loaded = (DMCICodec(load_native_into(DMCI(i_cfg), paths["DMCI"])
                            .state_dict(), cfg=i_cfg, **kw),
                  DMCHTCodec(load_native_into(DMCHT(p_cfg), paths["HTS"])
                             .state_dict(), cfg=p_cfg, **kw))
        sizes = {k: os.path.getsize(v) for k, v in paths.items()}
        io_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root)
    x = smooth_frame(1080, 1920, 11, dev)
    chunk = torch.cat(make_sequence(1080, 1920, 8, 12, dev), dim=-1)
    derived, runs = [0, 0, 0], []
    for tag, (ic, pc) in (("in memory", (dmci, hts)),
                          ("from params.v1", loaded)):
        res, _, *n = counted(launch_log, f"params.v1 DMCI {tag}",
                             lambda: ic.compress(x, 32))
        expect(f"params.v1 DMCI {tag}", tuple(n), (ENCODE_LAUNCHES, 0, 0))
        pc.clear_dpb()
        pc.add_ref_feature_from_frame(res["x_hat"])
        enc, _, *m = counted(launch_log, f"params.v1 HTS {tag}",
                             lambda: pc.compress(chunk, 32))
        want = unit_launches(VIDEO["HTS"], True, False, True, False)
        expect(f"params.v1 HTS {tag}", tuple(m), want)
        derived[0] += ENCODE_LAUNCHES + want[0]
        runs.append((res, enc, pc.ref_feature))
    (r1, e1, d1), (r2, e2, d2) = runs
    if r1["bit_stream"] != r2["bit_stream"] or not torch.equal(
            r1["x_hat"], r2["x_hat"]) or e1["bit_stream"] != \
            e2["bit_stream"] or not torch.equal(d1, d2):
        raise AssertionError("params.v1: the loaded codecs' streams, x_hat "
                             "or DPB differ from the in-memory codecs'")
    log(f"params.v1: DMCI {sizes['DMCI']} bytes, HTS {sizes['HTS']} bytes "
        f"written and read back in {io_s:.3f} s; a 1080p DMCI frame "
        f"({len(r1['bit_stream'])} bytes) and an HTS chunk "
        f"({len(e1['bit_stream'])} bytes) coded identically, DPB bit-exact "
        f"{tuple(d1.shape)} ({time.perf_counter() - t0:.3f} s)")
    return tuple(derived)


def phase_image_cli(dev, launch_log):
    """image_main (DMCIConfig(), bf16, seeded random weights, skip 0.15) on
    three seeded PNGs, with and without device_ec: every image bit-exact
    (exit code 0), the .bin files and the bits and PSNRs of the two runs
    equal.  Then image_main --i_frame_model evc, intra_noar, cheng2020 and
    bmshj2018 on the same PNGs (float32, --model_path: a params.v1 file of
    the legacy parts' weights, written by save_native): every image
    bit-exact, exit code 0 (float32, no K1Block: no launch).
    Returns the (S = 1, stacked, K2) launches derived for it."""
    t0 = time.perf_counter()
    root = scratch_dir("image")
    derived = [0, 0, 0]
    try:
        os.makedirs(os.path.join(root, "png"))
        for h, w, seed in IMAGE_CASES:
            frame = smooth_frame(h, w, seed, dev)
            write_png(os.path.join(root, "png", f"im_{w}x{h}.png"),
                      torch.round((frame[0] + 0.5) * 255).to(torch.uint8)
                      .cpu().numpy())
        runs = []
        for ec in (0, 1):
            argv = ["--image_path", os.path.join(root, "png"),
                    "--stream_path", os.path.join(root, f"bin{ec}"),
                    "--output_path", os.path.join(root, f"out{ec}.json"),
                    "--qp", "32", "--device_ec", str(ec),
                    "--device", dev.type]
            label = f"image CLI device_ec={ec}"
            rc, ms, *n = counted(launch_log, label,
                                 lambda: image_main.main(argv))
            k = len(IMAGE_CASES)
            want = (k * (ENCODE_LAUNCHES + DECODE_LAUNCHES), 0,
                    k * DMCI_K2_LAUNCHES * ec)
            expect(label, tuple(n), want)
            derived = [a + b for a, b in zip(derived, want)]
            with open(os.path.join(root, f"out{ec}.json")) as f:
                result = json.load(f)
            if rc != 0 or not all(r["bitexact"] for r in
                                  result["per_image"].values()):
                raise AssertionError(f"{label}: exit code {rc}, "
                                     f"{result['per_image']}")
            bins = {}
            for name in sorted(os.listdir(os.path.join(root, f"bin{ec}"))):
                with open(os.path.join(root, f"bin{ec}", name), "rb") as f:
                    bins[name] = f.read()
            runs.append((result, bins))
            log(f"{label}: " + "; ".join(
                f"{name} ms={1e3 * r['time']} bpp={r['bpp']} "
                f"psnr={r['psnr']} bitexact={r['bitexact']}"
                for name, r in result["per_image"].items())
                + f"; K1 {n[0]} + {n[1]} stacked, K2 {n[2]} launches "
                f"(run {ms} ms with its codec build)")
        (res0, bins0), (res1, bins1) = runs
        if bins0 != bins1 or any(
                (a["bpp"], a["psnr"]) != (b["bpp"], b["psnr"]) for a, b in
                zip(res0["per_image"].values(), res1["per_image"].values())):
            raise AssertionError("image CLI: the device_ec run differs")
        for model, weights in (
                ("evc", lambda: lifted_legacy_intra(EVCCodec.MODEL_CLS,
                                                    EVC_CONFIG, 20)),
                ("intra_noar",
                 lambda: lifted_legacy_intra(IntraNoARCodec.MODEL_CLS,
                                             INTRA_NOAR_CONFIG, 21)),
                *[(name, lambda name=name: lifted_compressai(
                    name, COMPRESSAI_CODECS[name][1], COMPRESSAI_SEEDS[name]))
                  for name in COMPRESSAI_CODECS]):
            path = os.path.join(root, f"{model}.bin")
            save_native(weights(), path)
            argv = ["--i_frame_model", model, "--model_path", path,
                    "--image_path", os.path.join(root, "png"),
                    "--stream_path", os.path.join(root, f"bin_{model}"),
                    "--output_path", os.path.join(root, f"{model}.json"),
                    "--q_scale", "1.1", "--device", dev.type]
            label = f"image CLI --i_frame_model {model}"
            rc, ms, *n = counted(launch_log, label,
                                 lambda: image_main.main(argv))
            expect(label, tuple(n), NO_LAUNCHES)
            with open(os.path.join(root, f"{model}.json")) as f:
                result = json.load(f)
            if rc != 0 or len(result["per_image"]) != len(IMAGE_CASES) \
                    or not all(r["bitexact"]
                               for r in result["per_image"].values()):
                raise AssertionError(f"{label}: exit code {rc}, "
                                     f"{result['per_image']}")
            log(f"{label} (params.v1 of the legacy parts' weights): "
                + "; ".join(f"{name} ms={1e3 * r['time']} bpp={r['bpp']} "
                            f"psnr={r['psnr']} bitexact={r['bitexact']}"
                            for name, r in result["per_image"].items())
                + f" (run {ms} ms with its codec build)")
    finally:
        shutil.rmtree(root)
    log(f"image CLI: {len(IMAGE_CASES)} images x 6 runs bit-exact (DMCI "
        f"host and device decodes equal; EVC, IntraNoAR, cheng2020, "
        f"bmshj2018) "
        f"({time.perf_counter() - t0:.3f} s)")
    return tuple(derived)


def untimed(result):
    """A result JSON without its time fields."""
    return {ds: {seq: {rate: {k: v for k, v in point.items()
                              if "time" not in k}
                       for rate, point in rates.items()}
                 for seq, rates in seqs.items()}
            for ds, seqs in result.items()}


def phase_workers(dev, launch_log):
    """video_main --model_structure ld --rate_num 2 on the evaluation
    entry's seeded 1080p file with --worker 1 (in this process) and
    --worker 2 (two spawned processes on the one card, each with its own
    codecs): the same .bin bytes and the same JSON numbers, times aside.
    The pool's launches happen in its processes and are not counted
    here.  Returns the (S = 1, stacked, K2) launches derived for it."""
    t0 = time.perf_counter()
    root = scratch_dir("workers")
    try:
        cfg_path, seq = write_cli_inputs(root, dev)
        out = {}
        for n in (1, 2):
            argv = ["--test_config", cfg_path, "--model_structure", "ld",
                    "--rate_num", "2", "--worker", str(n),
                    "--output_path", os.path.join(root, f"w{n}.json"),
                    "--stream_path", os.path.join(root, f"w{n}"),
                    "--device", dev.type]
            result, ms, *got = counted(launch_log, f"workers {n}",
                                       lambda: video_main.main(argv))
            points = video_main.build_points(video_main.parse_args(argv),
                                             DMCIConfig().qp_num)[0]
            want = [0, 0, 0]
            if n == 1:
                for point in points:
                    want = [a + b for a, b in
                            zip(want, cli_launches(VIDEO["LD"], point))]
            expect(f"workers {n}", tuple(got), tuple(want))
            if n == 1:
                derived = want
            bins = {}
            folder = os.path.join(root, f"w{n}", "Smoke")
            for name in sorted(os.listdir(folder)):
                if name.endswith(".bin"):
                    with open(os.path.join(folder, name), "rb") as f:
                        bins[name] = f.read()
            with open(os.path.join(root, f"w{n}.json")) as f:
                out[n] = (untimed(json.load(f)), bins, ms)
        if out[1][:2] != out[2][:2] or len(out[1][1]) != 2:
            raise AssertionError("--worker 2 differs from --worker 1")
        log(f"workers: video_main LD, 2 points of {CLI_FRAMES} "
            f"{CLI_W}x{CLI_H} frames: --worker 1 {out[1][2]} ms, "
            f"--worker 2 {out[2][2]} ms "
            f"wall (each with its codec builds; the pool's with its process "
            f"starts); .bin files and JSON numbers equal "
            f"({time.perf_counter() - t0:.3f} s)")
    finally:
        shutil.rmtree(root)
    return tuple(derived)


def phase_bd_gate(dev, launch_log):
    """bd_gate with random weights at full width (DMCI + HTS, bf16) and
    --allow_extrapolation, 4 rates on the GATE_H x GATE_W stand-in
    sequence of GATE_FRAMES frames: exit code 0 and a strict, finite
    JSON of 4 RD points.  Returns the (S = 1, stacked, K2) launches derived for it."""
    root = scratch_dir("gate")
    path = os.path.join(root, "gate.json")
    try:
        argv = ["--output_path", path, "--allow_extrapolation", "--frames",
                str(GATE_FRAMES), "--height", str(GATE_H), "--width",
                str(GATE_W), "--device", dev.type]
        rc, ms, *got = counted(launch_log, "BD gate",
                               lambda: bd_gate.main(argv))
        point = {"frame_num": GATE_FRAMES, "reset_interval": 32}
        want = tuple(4 * n for n in cli_launches(VIDEO["HTS"], point))
        expect("BD gate", tuple(got), want)

        def strict(token):
            raise AssertionError(f"BD gate JSON: {token}")
        with open(path) as f:
            artifact = json.load(f, parse_constant=strict)
    finally:
        shutil.rmtree(root)
    points = artifact["rd_points"]
    if rc != 0 or len(points) != 4 or not all(
            np.isfinite(p["bpp"]) and np.isfinite(p["psnr"]) and p["bpp"] > 0
            for p in points.values()):
        raise AssertionError(f"BD gate: exit code {rc}, points {points}")
    log(f"BD gate (pipeline validation, untrained full-width weights, "
        f"{GATE_FRAMES} frames of {GATE_W}x{GATE_H}): rd_monotone="
        f"{artifact['rd_monotone']} bd_rate_pct_vs_vtm17="
        f"{json.dumps(artifact['bd_rate_pct_vs_vtm17'])} RD points "
        + "; ".join(f"{k}: bpp={p['bpp']} psnr={p['psnr']}"
                    for k, p in points.items()) + f" ({ms} ms)")
    return want


def symbol_diff(a, b):
    """{kind: (differing, total)} between two captures of one call's
    symbols; y / idx of unequal length count the excess as differing."""
    out = {"z": (int((a["z"] != b["z"]).sum()), a["z"].size)}
    for kind in ("y", "idx"):
        bad = total = 0
        for u, v in zip(a[kind], b[kind]):
            m = min(len(u), len(v))
            bad += int((u[:m] != v[:m]).sum()) + abs(len(u) - len(v))
            total += max(len(u), len(v))
        out[kind] = (bad, total)
    return out


def phase_symbols(dev, launch_log):
    """Card vs CPU decisions (a measurement, as dcvc_tpu's
    scripts/cross_platform_conformance.py; not a gate): DMCI at
    DMCIConfig() in float32 (the plain DepthConvBlock: K1 runs bf16
    only), skip 0.15, seeded random weights, on a seeded SYMBOL_SIDE^2
    frame at SYMBOL_QPS, captured with collect_symbols on the card and on
    the CPU; the differing z / y / idx symbols are printed, and whether
    the CPU's decode of the card's stream reads the card's symbols.  The
    card's own round trip (host and K2 decodes) stays bit-exact.
    Returns the (S = 1, stacked, K2) launches derived for it."""
    t0 = time.perf_counter()
    kw = {"cfg": DMCIConfig(), "skip_thres": 0.15, "dtype": torch.float32}
    card = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                 device=dev, **kw)
    cpu = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                device="cpu", **kw)
    x = smooth_frame(SYMBOL_SIDE, SYMBOL_SIDE, 13, dev)
    side = SYMBOL_SIDE
    derived = [0, 0, 0]
    for qp in SYMBOL_QPS:
        card.collect_symbols = []

        def card_round_trip():
            res = card.compress(x, qp)
            host = card.decompress(res["bit_stream"], qp, side, side,
                                   res["ec_parallel"])["x_hat"]
            card.device_ec = True
            try:
                dev_x = card.decompress(res["bit_stream"], qp, side, side,
                                        res["ec_parallel"])["x_hat"]
            finally:
                card.device_ec = False
            return res, host, dev_x
        (res, host, dev_x), _, *n = counted(
            launch_log, f"symbols card qp={qp}", card_round_trip)
        want = (0, 0, DMCI_K2_LAUNCHES)
        expect(f"symbols card qp={qp}", tuple(n), want)
        derived[2] += want[2]
        if not (torch.equal(res["x_hat"], host)
                and torch.equal(host, dev_x)):
            raise AssertionError(f"symbols qp={qp}: the card's round trip "
                                 f"is not bit-exact")
        enc_card = card.collect_symbols[0]
        cpu.collect_symbols = []
        cpu.compress(x.cpu(), qp)
        cpu.decompress(res["bit_stream"], qp, side, side,
                       res["ec_parallel"])
        enc_cpu, dec_cpu = cpu.collect_symbols
        diff = symbol_diff(enc_card, enc_cpu)
        portable = all(v[0] == 0 for v in symbol_diff(enc_card,
                                                      dec_cpu).values())
        log(f"symbols card vs CPU, DMCI f32 {side}x{side} qp={qp}: "
            + "; ".join(f"{k} {bad} of {tot} differ (share {bad / tot})"
                        for k, (bad, tot) in diff.items())
            + f"; card stream read on the CPU gives the card's symbols: "
            f"{portable}; card round trip bit-exact (host and K2)")
    log(f"symbols: {time.perf_counter() - t0:.3f} s")
    return tuple(derived)


def phase_complexity():
    """kMACs per pixel of each full-width model's training forward at
    1080p (1088x1920, the training forward's multiple of 64; DCVC-FM,
    HEM and DC: the eval forward of a later P frame), counted by
    FlopCounterMode on the
    meta device (shapes only, no compute): products and convolutions, not
    elementwise work; DCVC-2021: the eval forward of a P frame; DCVC-TCM:
    the training forward of a later P frame; the CompressAI models: the
    estimation forward of an image."""
    t0 = time.perf_counter()
    parts = []
    for name, cls, cfg in (("DMCI", DMCI, DMCIConfig()),
                           ("HTS", DMCHT, HTS_CONFIG),
                           ("HTL", DMCHT, HTL_CONFIG),
                           ("LD", DMCLD, LD_CONFIG),
                           ("FM", DMCFM, FM_CONFIG),
                           ("HEM", DMCHEM, HEM_CONFIG),
                           ("DC", DMCDC, DC_CONFIG),
                           ("DCVC", DCVCNet, DCVC_CONFIG),
                           ("TCM", DMCTCM, TCM_CONFIG),
                           ("cheng2020", Cheng2020Anchor, CHENG2020_Q1_3),
                           ("bmshj2018", ScaleHyperprior, BMSHJ2018_Q1_5)):
        with torch.device("meta"):
            model = cls(cfg)
        parts.append(f"{name} {model_macs_per_pixel(model, 1080, 1920)}")
    log("complexity, kMACs per pixel at 1080p (training forward, "
        "FlopCounterMode, per frame): " + "; ".join(parts)
        + f" ({time.perf_counter() - t0:.3f} s)")


# ---------------------------------------------------------------- training

# card-vs-CPU parity of one training step at the TINY configs: random
# kernels x 0.7 as the CPU parity tests damp them (tests/test_torch_train.py)
PARITY_SCALE = 0.7
PARITY_LR = 1e-4
# metrics (loss, mse, bpp, grad_norm) relative to the CPU's: the same f32
# products, TF32 off, summed in another order by cuBLAS / cuDNN (the
# bound of the CPU tests' port against JAX)
PARITY_METRIC_REL = 1e-5
# parameters after the step: AdamW's first step moves an element by about
# lr * sign(g), so where the CPU's clipped |g| is at least 1e-3 of its
# tensor's peak and 100 eps the two must agree within 1e-6 of the tensor's
# peak |p| + 1e-4 lr, elsewhere (the sign may differ) within 2 lr more
PARITY_SIGN_SHARE = 1e-3


def parity_params(label, card, cpu, cpu_opt):
    """The card model's parameters after a step against the CPU model's
    (see PARITY_SIGN_SHARE); returns the count of elements past the
    tight bound."""
    state = cpu_opt.adamw.state
    loose = 0
    for (name, pc), p in zip(card.named_parameters(), cpu.parameters()):
        want = p.detach()
        g = state[p]["exp_avg"].abs() / (1 - 0.9)
        err = (pc.detach().cpu() - want).abs()
        tight = 1e-6 * float(want.abs().max()) + 1e-4 * PARITY_LR
        sure = g >= max(PARITY_SIGN_SHARE * float(g.max()), 1e-6)
        worst_sure = float(err[sure].max()) if bool(sure.any()) else 0.0
        if worst_sure > tight or float(err.max()) > 2 * PARITY_LR + tight:
            raise AssertionError(f"{label}: parameter {name} differs from "
                                 f"the CPU's by {float(err.max())}")
        loose += int((err > tight).sum())
    return loose


def phase_train_parity(dev):
    """One TINY DMCI image step (uint8 batch of 2 at qps 1 and 6) and one
    TINY HTS 2-chunk step (cascaded, remat) on the card against the same
    steps of the port on the CPU: the same weights, batch and noise (drawn
    on the CPU), TF32 off; metrics within PARITY_METRIC_REL, parameters
    within the bounds of PARITY_SIGN_SHARE."""
    rng = np.random.default_rng(5)
    qp = torch.tensor([1, 6])
    gen = torch.Generator().manual_seed(6)
    for name in ("DMCI", "HTS"):
        if name == "DMCI":
            cfg, clip = TINY_CONFIG, 0.1
            cpu = damped_model(DMCI, cfg, 0, PARITY_SCALE)
            batch = [torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3),
                                                   np.uint8))]
            noise = draw_noise(cfg, 2, 64, 64, gen, "cpu")
            keys = ("loss", "mse", "bpp", "bits_y", "bits_z", "grad_norm")
        else:
            cfg, clip = TINY_HT_CONFIG, 0.2
            cpu = damped_model(DMCHT, cfg, 0, PARITY_SCALE)
            batch = [torch.rand(2, 64, 64, 3, generator=gen) - 0.5,
                     torch.from_numpy(rng.integers(0, 256, (2, 2, 64, 64, 24),
                                                   np.uint8))]
            noise = [draw_noise(cfg, 2, 64, 64, gen, "cpu")
                     for _ in range(2)]
            keys = ("loss", "mse", "bpp", "grad_norm")
        card = copy.deepcopy(cpu).to(dev)
        lambdas = torch.tensor(get_training_lambdas((8.0, 256.0), cfg.qp_num),
                               dtype=torch.float32)
        got = {}
        for side, model, d in (("cpu", cpu, torch.device("cpu")),
                               ("card", card, dev)):
            opt = Optimizer(model, PARITY_LR, clip)

            def mv(t, d=d):
                return t.to(d)
            if name == "DMCI":
                m = image_train_step(model, opt, mv(batch[0]), mv(qp),
                                     mv(lambdas), {k: mv(v) for k, v in
                                                   noise.items()})
            else:
                m = video_train_step(
                    model, opt, mv(batch[0]), mv(batch[1]), mv(qp),
                    mv(lambdas), [{k: mv(v) for k, v in n.items()}
                                  for n in noise], cascaded=True,
                    use_remat=True)
            got[side] = (m, opt)
        (mc, opt_cpu), (mg, _) = got["cpu"], got["card"]
        errs = {k: abs(float(mg[k]) - float(mc[k])) / max(abs(float(mc[k])),
                                                          1e-6)
                for k in keys}
        if mc["skipped"] or mg["skipped"] or \
                max(errs.values()) > PARITY_METRIC_REL:
            raise AssertionError(f"{name} step on the card vs the CPU: "
                                 f"relative errors {errs}, skipped "
                                 f"{mc['skipped']} / {mg['skipped']}")
        loose = parity_params(name, card, cpu, opt_cpu)
        log(f"train parity {name} TINY step, card vs CPU (TF32 off): "
            f"metrics relative error {json.dumps(errs)} (tol "
            f"{PARITY_METRIC_REL}); parameters within bounds, {loose} "
            f"elements of near-zero gradient past the tight one")


def phase_train(dev):
    """The full-width trainers' steps (perf_probe.TRAIN_CELLS: DMCI, LD,
    HTS, HTL at their published widths, float32, TF32 off, random kernels
    x TRAIN_INIT_SCALE): per cell the ms per step (host clock around a
    synchronised step; median of the steps after the first),
    torch.cuda.max_memory_allocated, the losses and grad_norms.  Fails if
    a loss is not finite, a step was skipped or the parameters did not
    move.  The training forwards run the plain DepthConvBlock (K1 has no
    backward), so the part launches no kernel: returns (0, 0, 0)."""
    for cell in TRAIN_CELLS:
        torch.cuda.empty_cache()
        model, step = train_setup(cell, dev)
        before = [p.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses, norms = [], [], []
        for _ in range(cell.steps):
            t0 = time.perf_counter()
            m = step()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            if m["skipped"] or not bool(torch.isfinite(m["loss"])):
                raise AssertionError(f"train {cell.label}: loss "
                                     f"{float(m['loss'])}, skipped "
                                     f"{m['skipped']}")
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        moved = sum(int(not torch.equal(a, b))
                    for a, b in zip(before, model.parameters()))
        if not moved:
            raise AssertionError(f"train {cell.label}: no parameter moved")
        log("train " + json.dumps({
            "cell": cell.label, "params": sum(p.numel() for p in before),
            "ms_per_step": statistics.median(ms[1:]), "step_ms": ms,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated()
            / 2 ** 30, "losses": losses, "grad_norms": norms,
            "tensors_moved": f"{moved}/{len(before)}"}))
        del model, step, before
    return (0, 0, 0)


def write_train_folders(root, dev):
    """Synthetic training folders under root, the layout ImageFolder and
    VideoFolder read: `images/` (4 PNGs of TRAIN_SIDE^2 and
    description.json, a list of their names) and `video/` (2 sequences of
    3 frames, seq_{i}/im{n}.png, and description.json {seqs: [{path,
    height, width, seq_length}], frames: [names]}), written by the port's
    PNG writer from seeded smooth frames."""
    def u8(frame):
        return torch.round((frame[0] + 0.5) * 255).to(torch.uint8).cpu() \
            .numpy()
    side = TRAIN_SIDE
    images = os.path.join(root, "images")
    os.makedirs(images)
    names = [f"img_{i}.png" for i in range(4)]
    for i, name in enumerate(names):
        write_png(os.path.join(images, name),
                  u8(smooth_frame(side, side, 20 + i, dev)))
    with open(os.path.join(images, "description.json"), "w") as f:
        json.dump(names, f)
    video = os.path.join(root, "video")
    frames = [f"im{n + 1}.png" for n in range(3)]
    desc = {"seqs": [], "frames": frames}
    for i in range(2):
        os.makedirs(os.path.join(video, f"seq_{i}"))
        for n, frame in enumerate(make_sequence(side, side, 3, 30 + i, dev)):
            write_png(os.path.join(video, f"seq_{i}", frames[n]), u8(frame))
        desc["seqs"].append({"path": f"seq_{i}", "height": side,
                             "width": side, "seq_length": 3})
    with open(os.path.join(video, "description.json"), "w") as f:
        json.dump(desc, f)
    return images, video


def phase_trained_codecs(dev, launch_log, k2_log):
    """From the trainers to the codecs: image_main and video_main
    --model_structure ld (published widths, on the card) run 2 steps each
    on synthetic PNG folders written into a temporary directory of the
    checkout (read back by the port's PNG reader).  image_main starts, as
    the JAX trainer does, from undamped random weights; video_main from
    checkpoints of random weights damped by TRAIN_INIT_SCALE
    (--model_path_i, --pretrain_path), and neither of its steps may be
    skipped.  Their final ckpt.pth.tar files are loaded into DMCICodec and
    DMCLDCodec (bf16, skip 0.15), which code a 720p frame each: encoder,
    host decode and K2 decode bit-exact.  Returns the (S = 1, stacked,
    K2) launches derived for the coding, each call's checked."""
    root = tempfile.mkdtemp(prefix="_smoke_train_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        images, video = write_train_folders(root, dev)
        common = ["--device", dev.type, "--batch_size", "2", "-e", "1",
                  "--max_steps_per_epoch", "2", "--data_repeat", "2",
                  "-n", "2", "--lambdas", "8", "256"]
        out_i, out_p = os.path.join(root, "out_i"), os.path.join(root, "out_p")
        i_init = os.path.join(root, "i_init.pth.tar")
        ld_init = os.path.join(root, "ld_init.pth.tar")
        save_reference(i_init, damped_model(DMCI, DMCIConfig(), 10,
                                            TRAIN_INIT_SCALE))
        save_reference(ld_init, damped_model(DMCLD, LD_CONFIG, 0,
                                             TRAIN_INIT_SCALE))
        t0 = time.perf_counter()
        train_image_main.main(common + ["--train_dataset", images,
                                        "--save_dir", out_i])
        train_video_main.main(common + [
            "--train_dataset", video, "--save_dir", out_p,
            "--model_structure", "ld", "--model_path_i", i_init,
            "--pretrain_path", ld_init])
        taken = {}
        for name, out in (("image_main", out_i), ("video_main", out_p)):
            status = load_latest_status(out)
            taken[name] = min(int(s["step"]) for s in
                              status["optimizer"]["state"].values()) \
                if status["optimizer"]["state"] else 0
        if taken["video_main"] != 2:
            raise AssertionError(f"video_main took {taken['video_main']} "
                                 f"of its 2 steps")
        log(f"trainers: image_main and video_main --model_structure ld, 2 "
            f"steps each at the published widths, in "
            f"{time.perf_counter() - t0:.3f} s with their setup; AdamW "
            f"steps taken (not skipped): {json.dumps(taken)}")
        kw = {"dtype": torch.bfloat16, "device": dev, "skip_thres": 0.15}
        i_cfg = DMCIConfig()
        dmci = DMCICodec(load_reference_into(
            DMCI(i_cfg), os.path.join(out_i, "ckpt.pth.tar")).state_dict(),
            cfg=i_cfg, **kw)
        ld = DMCLDCodec(load_reference_into(
            DMCLD(LD_CONFIG), os.path.join(out_p, "ckpt.pth.tar"))
            .state_dict(), cfg=LD_CONFIG, **kw)
        derived = phase_codec(dmci, dev, launch_log, k2_log,
                              cases=[(720, 1280, 32, 9)])
        video_derived = phase_video("LD", dmci, ld, dev, launch_log, k2_log,
                                    cases=[(720, 1280, 32, 10, (False,))])
        log("trainers -> codecs: the trained checkpoints code bit-exact "
            "(DMCI, DMCI -> LD; encoder, host decode, K2 decode)")
    finally:
        shutil.rmtree(root)
    return tuple(a + b for a, b in zip(derived, video_derived))


# ---------------------------------------------- the spatial split of DMCI
# (h, w, qp, tiles, frame seed): 1080p and 2160p in 2 row tiles, 1080p in
# 4, each tile on cuda:0 (parallel/spatial.py)
SPATIAL_CASES = [(1080, 1920, 0, 2, 90), (1080, 1920, 32, 2, 90),
                 (2160, 3840, 0, 2, 91), (2160, 3840, 32, 2, 91),
                 (1080, 1920, 32, 4, 90)]
SPATIAL_TIMED = 11  # warm calls of each codec, their median printed
DDP_STEPS = 4       # steps per side of the DDP vs plain step timing
MASK_STEPS = 4      # mask-decay steps
STATUS_QP = 32      # the qp of the status checkpoint's codec check


def spatial_launches(h, w, tiles):
    """(encode, decode) K1 launches of a split DMCI call, derived from the
    model on the meta device over the tile shapes
    (perf_probe.spatial_dmci_launches)."""
    stages = spatial_dmci_launches(DMCIConfig(), h, w, tiles)
    n = {k: sum(v.values()) for k, v in stages.items()}
    return sum(n.values()), sum(n.values()) - n["analysis"]


def same_symbols(tag, enc, dec):
    """The decoder's collect_symbols entry equals the encoder's."""
    if not (np.array_equal(enc["z"], dec["z"])
            and all(np.array_equal(a, b) for k in ("y", "idx")
                    for a, b in zip(enc[k], dec[k]))):
        raise AssertionError(f"{tag}: the decoder's symbols differ from "
                             f"the encoder's")


def collected(codec, fn):
    """fn() with codec.collect_symbols on; returns (result, its entry)."""
    codec.collect_symbols = []
    try:
        out = fn()
        return out, codec.collect_symbols[0]
    finally:
        codec.collect_symbols = None


def phase_spatial(dev, launch_log, k2_log):
    """DMCICodec(spatial_devices=[cuda:0] * tiles) at DMCIConfig(), bf16,
    skip 0.15, the smoke's DMCI weights (seed 0), on SPATIAL_CASES: its
    encode -> host decode bit-exact with the decoder's symbols the
    encoder's, every encode the same bytes, and its K2 device decode
    bit-exact; the split stream decoded by the unsplit codec and the
    unsplit stream by the split codec, the symbols exact (the
    reconstructions' max |diff| printed: the synthesis runs on other
    shapes); K1 launches per call as spatial_launches derives; the
    medians of SPATIAL_TIMED warm encodes and decodes of both codecs.
    Returns the (S = 1, stacked, K2) launches derived for it."""
    kw = {"cfg": DMCIConfig(), "skip_thres": 0.15, "dtype": torch.bfloat16,
          "device": dev}
    whole = DMCICodec.init_random(torch.Generator().manual_seed(0), **kw)
    splits = {n: DMCICodec.init_random(torch.Generator().manual_seed(0),
                                       spatial_devices=[dev] * n, **kw)
              for n in sorted({c[3] for c in SPATIAL_CASES})}
    derived = [0, 0, 0]
    for h, w, qp, tiles, seed in SPATIAL_CASES:
        split = splits[tiles]
        enc_n, dec_n = spatial_launches(h, w, tiles)
        x = smooth_frame(h, w, seed, dev)
        tag = f"spatial DMCI {w}x{h} qp={qp} tiles={tiles}"
        ms = {}
        for name, codec, n_enc, n_dec in (
                ("split", split, enc_n, dec_n),
                ("unsplit", whole, ENCODE_LAUNCHES, DECODE_LAUNCHES)):
            def encode(run):
                return counted(launch_log, f"{tag} {name} {run} encode",
                               lambda: codec.compress(x, qp))

            def decode(run, res):
                return counted(launch_log, f"{tag} {name} {run} decode",
                               lambda: codec.decompress(
                                   bytes(res["bit_stream"]), qp, h, w,
                                   res["ec_parallel"])["x_hat"])
            (res, _, *e), enc_sym = collected(codec,
                                              lambda: encode("cold"))
            (x_dec, _, *d), dec_sym = collected(codec, lambda: decode(
                "cold", res))
            same_symbols(f"{tag} {name} round trip", enc_sym, dec_sym)
            stream = bytes(res["bit_stream"])
            times = []
            for run in range(1 + SPATIAL_TIMED):
                if run:
                    res, e_ms, *e = encode(f"warm {run}")
                    x_dec, d_ms, *d = decode(f"warm {run}", res)
                    times.append((e_ms, d_ms))
                if not torch.equal(res["x_hat"], x_dec) or \
                        not bool(torch.isfinite(x_dec).all()) or \
                        bytes(res["bit_stream"]) != stream:
                    raise AssertionError(f"{tag} {name}: not bit-exact or "
                                         f"not repeatable")
                expect(f"{tag} {name} encode", tuple(e), (n_enc, 0, 0))
                expect(f"{tag} {name} decode", tuple(d), (n_dec, 0, 0))
                derived[0] += n_enc + n_dec
            ms[name] = [statistics.median(t[i] for t in times)
                        for i in (0, 1)]
            if name == "split":
                x_dev, v_ms, *v = device_decode(
                    split, k2_log, f"{tag} device decode", launch_log,
                    stream, res["ec_parallel"], qp, h, w,
                    res["ec_parallel"])
                if not torch.equal(x_dev, res["x_hat"]):
                    raise AssertionError(f"{tag}: the K2 decode's x_hat "
                                         f"differs")
                expect(f"{tag} device decode", tuple(v),
                       (dec_n, 0, DMCI_K2_LAUNCHES))
                derived[0] += dec_n
                derived[2] += DMCI_K2_LAUNCHES
                split_stream, split_res = stream, res
            else:
                whole_stream, whole_res = stream, res
        diffs = {}
        for name, enc_codec, dec_codec, enc_res, n_enc, n_dec in (
                ("split -> unsplit", split, whole, split_res, enc_n,
                 DECODE_LAUNCHES),
                ("unsplit -> split", whole, split, whole_res,
                 ENCODE_LAUNCHES, dec_n)):
            (_, _, *e), enc_sym = collected(enc_codec, lambda: counted(
                launch_log, f"{tag} {name} encode",
                lambda: enc_codec.compress(x, qp)))
            (xc, _, *c), dec_sym = collected(dec_codec, lambda: counted(
                launch_log, f"{tag} {name} decode", lambda: dec_codec
                .decompress(bytes(enc_res["bit_stream"]), qp, h, w,
                            enc_res["ec_parallel"])["x_hat"]))
            same_symbols(f"{tag} {name}", enc_sym, dec_sym)
            expect(f"{tag} {name} encode", tuple(e), (n_enc, 0, 0))
            expect(f"{tag} {name} decode", tuple(c), (n_dec, 0, 0))
            derived[0] += n_enc + n_dec
            if not bool(torch.isfinite(xc).all()):
                raise AssertionError(f"{tag} {name}: non-finite x_hat")
            diffs[name] = float((xc - enc_res["x_hat"]).abs().max())
        log("spatial " + json.dumps({
            "case": tag, "bytes_split": len(split_stream),
            "bytes_unsplit": len(whole_stream),
            "same_bytes_as_unsplit": split_stream == whole_stream,
            "k1_per_call_enc_dec": [enc_n, dec_n],
            "warm_ms_split_enc_dec": ms["split"],
            "warm_ms_unsplit_enc_dec": ms["unsplit"],
            "device_decode_ms_split": v_ms,
            "ratio_enc_dec": [ms["split"][0] / ms["unsplit"][0],
                              ms["split"][1] / ms["unsplit"][1]],
            "cross_decode_max_abs_diff": diffs}))
    del whole, splits
    torch.cuda.empty_cache()
    return tuple(derived)


# ------------------------------------- the data scripts, DDP, status files


def phase_data_scripts(dev, root):
    """dcvc_tpu_torch.data.yuv_to_png on a seeded 1080p YUV420 file of 2
    frames (its PNGs, read back by utils/png.py, within one level of the
    port's ycbcr2rgb on the card), and dcvc_tpu_torch.data.make_synth on
    a corpus of 4 images and 4 sequences of 3 frames at TRAIN_SIDE (its
    PNGs read back, its description.json files complete).  Returns the
    corpus' (images, videos) folders; launches nothing."""
    from dcvc_tpu_torch.core.color import ycbcr2rgb
    from dcvc_tpu_torch.data import make_synth, yuv_to_png
    t0 = time.perf_counter()
    h, w = 1080, 1920
    raw = np.random.default_rng(17).integers(
        0, 256, 2 * h * w * 3 // 2, np.uint8)
    src = os.path.join(root, "seq.yuv")
    raw.tofile(src)
    dst = os.path.join(root, "png")
    if yuv_to_png.main(["--src", src, "--width", str(w), "--height",
                        str(h), "--dst", dst]) != 2:
        raise AssertionError("yuv_to_png: not 2 frames")
    worst = 0
    for n in range(2):
        frame = raw[n * h * w * 3 // 2:(n + 1) * h * w * 3 // 2]
        y = torch.from_numpy(frame[:h * w].reshape(h, w).copy())
        uv = torch.from_numpy(frame[h * w:].reshape(2, h // 2, w // 2)
                              .copy())
        uv = uv.repeat_interleave(2, 1).repeat_interleave(2, 2)
        yuv = torch.cat([y[None], uv]).to(dev).float().permute(1, 2, 0) / 255
        want = torch.round(ycbcr2rgb(yuv) * 255).clamp(0, 255).cpu()
        got = torch.from_numpy(load_rgb(os.path.join(
            dst, f"im{n + 1:05d}.png"))).float()
        worst = max(worst, float((got - want).abs().max()))
    if worst > 1:
        raise AssertionError(f"yuv_to_png: PNG pixels {worst} levels off "
                             f"the card's conversion")
    synth = os.path.join(root, "synth")
    images, videos = make_synth.main(["--root", synth, "--images", "4",
                                      "--seqs", "4", "--frames", "3",
                                      "--size", str(TRAIN_SIDE)])
    with open(os.path.join(videos, "description.json")) as f:
        desc = json.load(f)
    for seq in desc["seqs"]:
        for name in desc["frames"]:
            if load_rgb(os.path.join(videos, seq["path"], name)).shape != \
                    (TRAIN_SIDE, TRAIN_SIDE, 3):
                raise AssertionError("make_synth: a frame of another size")
    with open(os.path.join(images, "description.json")) as f:
        if len(json.load(f)) != 4:
            raise AssertionError("make_synth: not 4 images")
    log(f"data scripts: yuv_to_png 2 1080p frames (PNG vs the card's "
        f"ycbcr2rgb, max |diff| {worst} levels), make_synth 4 images + 4 x "
        f"3 frames at {TRAIN_SIDE}^2, read back, in "
        f"{time.perf_counter() - t0:.3f} s")
    return images, videos


class TorchrunEnv:
    """Inside, the environment of rank 0 of a torchrun job of one rank on
    a free local port (WORLD_SIZE=1): the trainers join a NCCL group."""

    def __enter__(self):
        from dcvc_tpu_torch.parallel.ddp import free_port
        env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
        self.saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_ddp(dev, root, images, videos):
    """Data-parallel training (parallel/ddp.py), f32 at the published
    widths: train.image_main and train.video_main --model_structure ld
    through their CLIs as rank 0 of a one-rank NCCL job (TorchrunEnv), 2
    steps each on make_synth's corpus at perf_probe.TRAIN_CELLS' batch 4
    (video_main from damped checkpoints: neither step skipped); one
    step of the DMCI and LD cells with the NCCL all-reduce against the
    plain step (the same parameters after it, bit for bit; ms per step,
    medians of DDP_STEPS alternating); and dryrun_multichip(2) on cuda:0
    over gloo against one process, on its smooth pictures and on uniform
    noise (the TINY LD near overflow).  Launches no kernel."""
    import torch.distributed as dist
    from dcvc_tpu_torch.parallel import ddp, dryrun
    common = ["--device", dev.type, "--batch_size", "4", "-e", "1",
              "--max_steps_per_epoch", "2", "--data_repeat", "2", "-n", "1",
              "--lambdas", "8", "256"]
    out_i, out_p = os.path.join(root, "ddp_i"), os.path.join(root, "ddp_p")
    i_init = os.path.join(root, "i_init.pth.tar")
    ld_init = os.path.join(root, "ld_init.pth.tar")
    save_reference(i_init, damped_model(DMCI, DMCIConfig(), 10,
                                        TRAIN_INIT_SCALE))
    save_reference(ld_init, damped_model(DMCLD, LD_CONFIG, 0,
                                         TRAIN_INIT_SCALE))
    t0 = time.perf_counter()
    with TorchrunEnv():
        train_image_main.main(common + ["--train_dataset", images,
                                        "--save_dir", out_i,
                                        "--max_patch", str(TRAIN_SIDE)])
    with TorchrunEnv():
        train_video_main.main(common + [
            "--train_dataset", videos, "--save_dir", out_p,
            "--model_structure", "ld", "--model_path_i", i_init,
            "--pretrain_path", ld_init, "--max_patch", str(TRAIN_SIDE)])
    if dist.is_initialized():
        raise AssertionError("a trainer left its process group")
    taken = {}
    for name, out in (("image_main", out_i), ("video_main", out_p)):
        status = load_latest_status(out)
        taken[name] = min(int(s["step"]) for s in
                          status["optimizer"]["state"].values()) \
            if status["optimizer"]["state"] else 0
    if taken["video_main"] != 2 or status["step"] != 2:
        raise AssertionError(f"video_main under WORLD_SIZE=1: {taken}")
    log(f"DDP trainers (WORLD_SIZE=1, NCCL): image_main and video_main "
        f"--model_structure ld, 2 steps each at batch 4, in "
        f"{time.perf_counter() - t0:.3f} s with their setup; AdamW steps "
        f"taken: {json.dumps(taken)}")
    with TorchrunEnv():
        rank = ddp.from_env(str(dev))
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"backend {dist.get_backend()}")
            for cell in TRAIN_CELLS[:2]:
                sides = {}
                for dp_on in (False, True, True, False):
                    torch.cuda.empty_cache()
                    model, step = train_setup(cell, dev,
                                              data_parallel=dp_on)
                    step()
                    torch.cuda.synchronize()
                    first = [p.detach().clone() for p in model.parameters()]
                    times = []
                    for _ in range(DDP_STEPS):
                        t1 = time.perf_counter()
                        m = step()
                        torch.cuda.synchronize()
                        times.append(1e3 * (time.perf_counter() - t1))
                    sides.setdefault(dp_on, []).append((first, times, m))
                    del model, step
                for a, b in zip(sides[False][0][0], sides[True][0][0]):
                    if not torch.equal(a, b):
                        raise AssertionError(f"DDP {cell.label}: the step "
                                             f"differs from the plain one")
                log("DDP step " + json.dumps({
                    "cell": cell.label, "world_size": rank.world,
                    "ms_plain": [t for _, t, _ in sides[False]],
                    "ms_ddp_nccl": [t for _, t, _ in sides[True]],
                    "median_plain": statistics.median(
                        sum((t for _, t, _ in sides[False]), [])),
                    "median_ddp": statistics.median(
                        sum((t for _, t, _ in sides[True]), [])),
                    "same_parameters_after_a_step": True}))
        finally:
            ddp.shutdown(rank)
    for inputs in ("smooth", "noise"):
        t0 = time.perf_counter()
        result = dryrun.dryrun_multichip(2, str(dev), inputs=inputs)
        log(f"dryrun_multichip(2) on {dev} over gloo, {inputs} inputs: "
            + json.dumps(result) + f", {time.perf_counter() - t0:.3f} s "
            f"with the spawns")
    return (0, 0, 0)


def phase_entry(dev):
    """parallel/dryrun.entry(): the DMCI training forward at 256x256 in
    bf16 on the card, finite, timed (warm, median of 5).  Runs before
    the main path's counts (its DCBs go through K1)."""
    from dcvc_tpu_torch.parallel.dryrun import entry
    fn, args = entry(str(dev))
    with torch.no_grad():
        fn(*args)
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x_hat, bpp, mse = fn(*args)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
    if x_hat.shape != (1, 256, 256, 3) or not all(
            bool(torch.isfinite(t.float()).all()) for t in (x_hat, bpp, mse)):
        raise AssertionError("entry(): a non-finite or misshapen output")
    log(f"entry(): DMCI forward 256x256 bf16, bpp {float(bpp)}, "
        f"ms {statistics.median(ms)} (median of 5)")


def phase_status(dev, root, launch_log):
    """The JAX trainers' status files at the published DMCI width (f32):
    after one step (perf_probe.TRAIN_CELLS[0]'s batch) the model and its
    AdamW state are written as a JAX status (utils/jax_status.py), read
    back into a fresh model, and its next step equals the next step of
    the run that did not stop, bit for bit (parameters, moments,
    metrics); status_to_ckpt turns the file into params.v1, and the DMCI
    codec from it (bf16) codes a 720p frame to the bytes of the codec
    from the in-memory weights.  Launches nothing but the codecs' K1
    (counted outside the main path's parts: returns the launches it
    derives)."""
    from dcvc_tpu_torch.utils import jax_status, status_to_ckpt
    cfg = DMCIConfig()
    cell = TRAIN_CELLS[0]
    b, side = cell.batch, cell.patch
    gen = torch.Generator(device=dev).manual_seed(43)
    x = torch.round((torch.cat([smooth_frame(side, side, 60 + i, dev)
                                for i in range(b)]) + 0.5) * 255) \
        .to(torch.uint8)
    qp = torch.arange(b, device=dev) * 17 % cfg.qp_num
    lambdas = torch.tensor(get_training_lambdas(TRAIN_LAMBDAS, cfg.qp_num),
                           dtype=torch.float32, device=dev)
    noise = [draw_noise(cfg, b, side, side, gen, dev) for _ in range(2)]
    a = damped_model(DMCI, cfg, 0, TRAIN_INIT_SCALE).to(dev)
    opt_a = Optimizer(a, TRAIN_LR, 0.1)
    image_train_step(a, opt_a, x, qp, lambdas, noise[0])
    snapshot = {k: v.detach().cpu().clone() for k, v in
                a.state_dict().items()}
    status_dir = os.path.join(root, "status")
    t0 = time.perf_counter()
    jax_status.save_status(status_dir, a, opt_a, 0, cfg)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(jax_status.status_path(status_dir, 0))
    m_a = image_train_step(a, opt_a, x, qp, lambdas, noise[1])
    b_model = DMCI(cfg).to(dev)
    opt_b = Optimizer(b_model, TRAIN_LR, 0.1)
    t0 = time.perf_counter()
    epoch = jax_status.load_into(b_model, opt_b,
                                 jax_status.load_latest_status(status_dir))
    read_s = time.perf_counter() - t0
    m_b = image_train_step(b_model, opt_b, x, qp, lambdas, noise[1])
    same = epoch == 0 and all(
        float(m_a[k]) == float(m_b[k]) for k in ("loss", "grad_norm")) \
        and all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                   b_model.parameters())) \
        and all(torch.equal(opt_a.adamw.state[p][k],
                            opt_b.adamw.state[q][k])
                for p, q in zip(a.parameters(), b_model.parameters())
                for k in ("exp_avg", "exp_avg_sq"))
    if not same:
        raise AssertionError("the step resumed from the JAX status differs "
                             "from the uninterrupted run's")
    del a, b_model, opt_a, opt_b
    ckpt = os.path.join(root, "status_ckpt.bin")
    if status_to_ckpt.main([status_dir, ckpt]) != 0:
        raise AssertionError("status_to_ckpt failed")
    kw = {"cfg": cfg, "skip_thres": 0.15, "dtype": torch.bfloat16,
          "device": dev}
    frame = smooth_frame(720, 1280, 61, dev)
    streams = []
    for state in (snapshot, load_native_into(DMCI(cfg), ckpt).state_dict()):
        codec = DMCICodec(state, **kw)
        res, _, *n = counted(launch_log, "status -> params.v1 encode",
                             lambda: codec.compress(frame, STATUS_QP))
        expect("status -> params.v1 encode", tuple(n),
               (ENCODE_LAUNCHES, 0, 0))
        streams.append(bytes(res["bit_stream"]))
        del codec
    if streams[0] != streams[1]:
        raise AssertionError("status_to_ckpt's params.v1 codes other bytes")
    log(f"JAX status at DMCIConfig(): {size} bytes, written in {write_s:.3f}"
        f" s, read in {read_s:.3f} s; the resumed step equals the "
        f"uninterrupted one bit for bit (loss {float(m_b['loss'])}); "
        f"status_to_ckpt -> params.v1 codes a 720p frame to the same "
        f"{len(streams[0])} bytes")
    torch.cuda.empty_cache()
    return (2 * ENCODE_LAUNCHES, 0, 0)


def phase_mask_decay(dev):
    """EVC's mask decay (train/mask_decay.py) at EVC_LL_CONFIG, f32, TF32
    off, random kernels x TRAIN_INIT_SCALE: all-ones gates fold to the
    model itself and a zero gate equals the hard-pruned channel, both bit
    for bit on the card; then MASK_STEPS steps (lam 0.1, decay 3.0) on a
    batch of 2 256x256 uint8 images: every loss finite, no step skipped,
    the gates' total |m| falling; ms per step.  Launches nothing."""
    from dcvc_tpu_torch.legacy.evc import EVC, EVC_LL_CONFIG
    from dcvc_tpu_torch.train import mask_decay as md
    model = damped_model(EVC, EVC_LL_CONFIG, 3, TRAIN_INIT_SCALE).to(dev)
    x = torch.round((torch.cat([smooth_frame(256, 256, 70 + i, dev)
                                for i in range(2)]) + 0.5) * 255) \
        .to(torch.uint8)
    x01 = x.float() / 255
    masks = md.init_masks(model)
    keys = md.conv1_keys(model)
    zeroed = sorted(masks)[:3]
    gated = {k: m.clone() for k, m in masks.items()}
    pruned = copy.deepcopy(model)
    with torch.no_grad():
        for site in zeroed:
            gated[site][[0, 3]] = 0.0
            for key in keys[site]:
                if key is not None:
                    pruned.get_parameter(key)[[0, 3]] = 0.0
        ones = md.folded_forward(model, masks, x01)
        plain = model(x01)
        got = md.folded_forward(model, gated, x01)
        want = pruned(x01)
    if not all(torch.equal(ones[k], plain[k]) and torch.equal(got[k],
                                                              want[k])
               for k in ("x_hat", "bpp")):
        raise AssertionError("mask decay: a fold is not exact on the card")
    del pruned
    opt = md.create_mask_decay_state(model, TRAIN_LR, 0.1)
    step = md.make_mask_decay_step(model, opt, 0.1, 3.0)
    total = [sum(float(m.abs().sum()) for m in masks.values())]
    ms, losses = [], []
    for _ in range(MASK_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks, m = step(masks, x)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if m["skipped"] or not bool(torch.isfinite(m["loss"])):
            raise AssertionError(f"mask decay: loss {float(m['loss'])}, "
                                 f"skipped {m['skipped']}")
        losses.append(float(m["loss"]))
        total.append(sum(float(g.abs().sum()) for g in masks.values()))
    if not all(b < a for a, b in zip(total, total[1:])):
        raise AssertionError(f"mask decay: the gates did not decay {total}")
    rep = md.sparsity_report(masks, thresh=0.9)
    log("mask decay " + json.dumps({
        "config": "EVC_LL", "batch": "2x256x256", "sites": len(masks),
        "gates": rep["total_gates"], "ms_per_step": ms,
        "median_ms_after_first": statistics.median(ms[1:]),
        "losses": losses, "gate_abs_sum": total,
        "share_below_0.9": rep["overall"]}))
    del model, opt, step
    torch.cuda.empty_cache()
    return (0, 0, 0)


# ---------------------------------- the speed and conformance entry points

# bench_variants runs of phase_entry_points, (variant, resolution,
# device_ec), each at the JAX script's protocol
ENTRY_VARIANTS = ([(v, "1080p", ec) for ec in (False, True)
                   for v in ("dmci", "htl", "hts")]
                  + [("dmci", "240p", False)]
                  + [("hts", r, False) for r in ("240p", "480p", "2160p")])
ENTRY_SEED = 90
# compress_time: LD (a unit is a frame) on a seeded 1080p HEVC_B sequence
# of ENTRY_CT_FRAMES frames, one past the harness's 4 warm-up units
ENTRY_CT_FRAMES = 5
ENTRY_TIMEOUT = 900      # seconds, for each process the phase starts
# the HTS chunks whose device decodes are replayed (phase_envelope_k2)
ENVELOPE_K2 = ("240p", "2160p")
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]
VARIANT_KEYS = BENCH_KEYS + ["enc_fps", "dec_fps", "dec_device_fps", "bpp"]


def variant_launches(variant, res, device_ec):
    """(S = 1, stacked, K2) launches of one bench_variants run at its
    protocol, from perf_probe.uf_call_launches at its size: DMCI 4 passes
    of 8 encodes and 8 decodes, then 4 zero-symbol decode chains; HT 5
    passes of 6 chunks, encoded (the first after the seed, no recon) and
    decoded (recon heads), then 4 chains (adaptor_m, the decode trunk and
    the recon heads); a device decode adds its K2 calls."""
    cfg = {"dmci": DMCIConfig(), "hts": HTS_CONFIG,
           "htl": HTL_CONFIG}[variant]
    n = uf_call_launches(variant, cfg, *bench_variants.RESOLUTIONS[res])
    chains = 4
    if variant == "dmci":
        passes, images = 4, 8
        return (passes * images * (n["encode"] + n["decode"])
                + chains * n["decode"], 0,
                passes * images * DMCI_K2_LAUNCHES if device_ec else 0)
    passes, chunks = 5, 6
    r1, rs = n["recon"]
    s1 = passes * (n["first_encode"] + n["first_decode"]
                   + (chunks - 1) * (n["encode"] + n["decode"])
                   + chunks * r1) + chains * (n["decode"] + r1)
    k2 = VIDEO[variant.upper()]["k2"]
    return (s1, (passes * chunks + chains) * rs,
            passes * chunks * k2 if device_ec else 0)


def phase_envelope_k2(dmci, hts, dev, launch_log, k2_log):
    """One HTS chunk at each size of ENVELOPE_K2 (its DPB seeded by a DMCI
    frame) encoded with recon and decoded on the card: the device decode's
    K2 calls are recorded for the replay against the plain version, and
    its frames equal the encoder's.  Returns the (S = 1, stacked, K2)
    launches derived for it."""
    spec = VIDEO["HTS"]
    derived = [0, 0, 0]

    def tally(tag, got, want):
        expect(tag, got, want)
        for i in range(3):
            derived[i] += want[i]

    for res in ENVELOPE_K2:
        h, w = bench_variants.RESOLUTIONS[res]
        frames = make_sequence(h, w, 9, ENTRY_SEED + 5, dev)
        label = f"envelope HTS {w}x{h} qp={STAGE_QP}"
        intra, _, *n = counted(launch_log, f"{label} intra frame (DMCI "
                               f"encode)", lambda: dmci.compress(
                                   frames[0], STAGE_QP)["x_hat"])
        tally(f"{label} intra frame", tuple(n), (ENCODE_LAUNCHES, 0, 0))
        chunk = torch.cat(frames[1:], dim=-1)
        hts.clear_dpb()
        hts.add_ref_feature_from_frame(intra)
        res_, _, *n = counted(launch_log, f"{label} chunk encode (recon)",
                              lambda: hts.compress(chunk, STAGE_QP,
                                                   recon=True))
        tally(f"{label} encode", tuple(n),
              expected_launches(spec, (False,), 0, True, True))
        hts.clear_dpb()
        hts.add_ref_feature_from_frame(intra)
        ec = res_["ec_parallel"]
        x_dev, ms, *n = device_decode(hts, k2_log, f"{label} device decode",
                                      launch_log, bytes(res_["bit_stream"]),
                                      ec, STAGE_QP, h, w, ec)
        s1, st, _ = expected_launches(spec, (False,), 0, False, True)
        tally(f"{label} device decode", tuple(n), (s1, st, spec["k2"]))
        if not torch.equal(x_dev, res_["x_hat"]):
            raise AssertionError(f"{label}: the device decode's frames "
                                 f"differ from the encoder's")
        log(f"{label}: {len(res_['bit_stream'])} bytes, device decode "
            f"bit-exact ({ms} ms cold), its {spec['k2']} K2 calls recorded")
    hts.clear_dpb()
    torch.cuda.empty_cache()
    return tuple(derived)


def _refuse_download(url, target):
    raise AssertionError(f"download_checkpoints tried the network: {url}")


def phase_entry_points(dev, launch_log):
    """The JAX repo's speed and conformance entry points, ported:
    `python3 -m dcvc_tpu_torch.bench` in its own process at its protocol
    (the last line bench.py's four keys, value > 0, no error);
    eval/bench_variants.py's runs of ENTRY_VARIANTS in this process, on a
    seeded sequence made on the card per size (perf_probe.make_sequence,
    48 frames; DMCI codes the first 8), each JSON line with the script's
    fields, value > 0, its K1 / K2 launches as derived (variant_launches)
    and every zero-symbol chain run with host syncs an error;
    eval/compress_time.py (LD, its own process for the entry) on a seeded
    1080p HEVC_B sequence of ENTRY_CT_FRAMES frames; eval/cross_platform
    run (its six processes: SMALL configs in float32, encoded on the card
    and on the CPU, each decoded on both): both same-platform legs
    identical, the card <-> CPU legs printed; utils/download_checkpoints
    --import_native on the DCVC-UF family with cvpr2026_image.pth.tar in
    place (a seeded DMCIConfig() model saved as a reference file; the
    other files are share folders, MANUAL, exit code 2; a download
    attempt fails the phase), its params.v1 equal to the model.  Prints
    nvidia-smi beside the numbers.  Returns the (S = 1, stacked, K2)
    launches derived for the in-process runs (the other processes'
    launches are their own)."""
    root = os.path.dirname(os.path.abspath(__file__))
    smi = nvidia_smi()
    derived = [0, 0, 0]
    t_phase = time.perf_counter()

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "dcvc_tpu_torch.bench"],
                         cwd=root, capture_output=True, text=True,
                         timeout=ENTRY_TIMEOUT)
    lines = res.stdout.strip().splitlines()
    rec = json.loads(lines[-1]) if res.returncode == 0 and lines else {}
    if list(rec) != BENCH_KEYS or not rec["value"] > 0:
        raise AssertionError(f"bench: rc {res.returncode}\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    for line in res.stderr.splitlines():
        if line.startswith("#"):
            log(f"  bench {line}")
    log(lines[-1])
    log(f"bench (python3 -m dcvc_tpu_torch.bench, HTS 1080p, its protocol;"
        f" {time.perf_counter() - t0:.3f} s with its start; {smi}): "
        f"{lines[-1]}")

    for size in ("1080p", "240p", "480p", "2160p"):
        h, w = bench_variants.RESOLUTIONS[size]
        seq = make_sequence(h, w, 48, ENTRY_SEED, dev)
        for variant, r, ec in ENTRY_VARIANTS:
            if r != size:
                continue
            label = (f"bench_variants {variant} {size}"
                     + (" device_ec" if ec else ""))
            t0 = time.perf_counter()
            with launch_log.call(label):
                before = launch_counts()
                if variant == "dmci":
                    rec = bench_variants.bench_dmci(h, w, size, device_ec=ec,
                                                    device=dev, frames=seq)
                else:
                    rec = bench_variants.bench_ht(h, w, variant, size,
                                                  device_ec=ec, device=dev,
                                                  frames=seq)
                torch.cuda.synchronize()
                got = tuple(a - b for a, b in zip(launch_counts(), before))
            want = variant_launches(variant, size, ec)
            expect(label, got, want)
            for i in range(3):
                derived[i] += want[i]
            if list(rec) != VARIANT_KEYS or not rec["value"] > 0:
                raise AssertionError(f"{label}: {rec}")
            log(f"{label}: {json.dumps(rec)} ({time.perf_counter() - t0:.3f}"
                f" s with its codec's set-up; launches {got} as derived; "
                f"{smi})")
        del seq
        torch.cuda.empty_cache()

    d = scratch_dir("entry")
    t0 = time.perf_counter()
    cfg = compress_time.write_sequence(d, 1080, 1920, ENTRY_CT_FRAMES)
    avg_enc, avg_dec = compress_time.main([
        "--model_structure", "ld", "--test_config", cfg,
        "--output_path", os.path.join(d, "runtime_out.json"),
        "--stream_path", os.path.join(d, "bins")])
    log(f"compress_time LD, 1080p HEVC_B, {ENTRY_CT_FRAMES} frames x 4 "
        f"rates: encode {avg_enc * 1e3} ms, decode {avg_dec * 1e3} ms a "
        f"frame after the 4 warm-up units ({time.perf_counter() - t0:.3f} s"
        f" with its sequence and process; {smi})")

    t0 = time.perf_counter()
    art = cross_platform.main(["run", "--dir", os.path.join(d, "xplat"),
                               "--artifact",
                               os.path.join(d, "CROSS_PLATFORM.json")])
    for leg, rep in art["results"].items():
        if "error" in rep:
            log(f"cross_platform {leg}: {rep['error']}")
            continue
        log(f"cross_platform {leg}: image " + "; ".join(
            f"qp {e['qp']} symbols_identical={e['symbols_identical']} "
            f"bitexact={e['recon_bitexact']} psnr={e['recon_psnr_vs_encoder']}"
            for e in rep["image"]) + "; video " + "; ".join(
            f"chunk {e['chunk']} bitexact={e['recon_bitexact']} "
            f"psnr={e['recon_psnr_vs_encoder']}" for e in rep["video"]))
    log(f"cross_platform run: same-platform legs identical "
        f"{art['same_platform_identical']} "
        f"({time.perf_counter() - t0:.3f} s, six processes)")

    t0 = time.perf_counter()
    ck = os.path.join(d, "checkpoints")
    os.makedirs(os.path.join(ck, "uf"))
    model = DMCI(DMCIConfig())
    model.reset_parameters(torch.Generator().manual_seed(ENTRY_SEED + 1))
    src = os.path.join(ck, "uf", "cvpr2026_image.pth.tar")
    save_reference(src, model)
    saved = download_checkpoints.urlretrieve
    download_checkpoints.urlretrieve = _refuse_download
    try:
        rc = download_checkpoints.main(["uf", "--root", ck,
                                        "--import_native"])
    finally:
        download_checkpoints.urlretrieve = saved
    native = os.path.join(ck, "uf", "cvpr2026_image.native.bin")
    back = load_native_into(DMCI(DMCIConfig()), native).state_dict()
    if rc != 2 or not all(torch.equal(back[k], v)
                          for k, v in model.state_dict().items()):
        raise AssertionError(f"download_checkpoints --import_native: rc {rc}"
                             f" or its params.v1 differs from the model")
    log(f"download_checkpoints uf --import_native: the reference file in "
        f"place converted to {os.path.getsize(native)} bytes of params.v1, "
        f"equal to the model; 3 share-folder files MANUAL (rc 2); no "
        f"download tried ({time.perf_counter() - t0:.3f} s)")
    shutil.rmtree(d)
    log(f"entry points: {time.perf_counter() - t_phase:.3f} s")
    return tuple(derived)


def zero_launch_counts():
    K1.fused_dcb.launches = K1.fused_dcb_stacked.launches = 0
    K2.rans_decode.launches = 0


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=("all", "traced"), default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    # one nvcc per library, started together: K1, K2 and K2's
    # cycle-counting build
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        for build in [pool.submit(K1.load_kernel), pool.submit(K2.load_kernel),
                      pool.submit(K2.load_kernel, True)]:
            build.result()
    log(f"build: fused_dcb.cu, rans_decode.cu (and -DK2_CLOCKS) -> sm_90a "
        f"in {time.perf_counter() - t0:.3f} s")
    if args.phase == "traced":
        spec = VIDEO["HTS"]
        phase_traced(
            DMCICodec.init_random(torch.Generator().manual_seed(0),
                                  cfg=DMCIConfig(), skip_thres=0.15,
                                  dtype=torch.bfloat16, device=dev),
            spec["codec"].init_random(
                torch.Generator().manual_seed(0), cfg=spec["cfg"],
                init_scale=0.5, skip_thres=0.15, dtype=torch.bfloat16,
                device=dev), dev)
        log(f"smoke total: {time.perf_counter() - t0:.3f} s")
        return 0
    phase_sass()
    with torch.inference_mode():
        phase_edge_shapes(dev)
        phase_k2_fixtures(dev)

    dmci = DMCICodec.init_random(torch.Generator().manual_seed(0),
                                 cfg=DMCIConfig(), skip_thres=0.15,
                                 dtype=torch.bfloat16, device=dev)
    video = {name: spec["codec"].init_random(
        torch.Generator().manual_seed(0), cfg=spec["cfg"], init_scale=0.5,
        skip_thres=0.15, dtype=torch.bfloat16, device=dev)
        for name, spec in VIDEO.items()}
    ld_shapes = ld_spec(VIDEO["LD"])
    rt_intra = RTIntraCodec.init_random(
        torch.Generator().manual_seed(0), cfg=DMCIRTConfig(),
        skip_thres=0.15, dtype=torch.bfloat16, device=dev)
    rt_p = DMCRTCodec.init_random(
        torch.Generator().manual_seed(1), cfg=RT_CONFIG, init_scale=0.4,
        skip_thres=0.15, dtype=torch.bfloat16, device=dev)
    rt, rt_shapes = rt_spec()
    rt_f32, _ = rt_spec(torch.float32)
    legacy = legacy_codecs(dev)
    fm_p = fm_p_codec(dev)
    hem_p, dc_p = hem_p_codec(dev), dc_p_codec(dev)
    compressai, dcvc_p = compressai_codecs(dev), dcvc_p_codec(dev)
    tcm_p = tcm_p_codec(dev)
    phase_stages(dmci)
    for name, codec in video.items():
        phase_stages_video(name, codec)
    phase_stages(rt_intra, "RT intra")
    phase_stages_video("RT", rt_p)
    for name in ("EVC", "IntraNoAR"):
        phase_stages_legacy(name, legacy[name])
    phase_stages_fm(fm_p)
    phase_stages_hem(hem_p)
    phase_stages_fm(dc_p, "DC")
    phase_stages_compressai_dcvc(compressai, dcvc_p)
    phase_stages_tcm(tcm_p)
    phase_train_parity(dev)
    phase_entry(dev)

    # the main path, one part at a time, each with the counts set to 0
    # just before it and read just after; K2's calls are recorded for
    # their replay in every part but the evaluation entry's
    launch_log, k2_log = LaunchLog(), K2Log()
    parts = [("DMCI", lambda: phase_codec(dmci, dev, launch_log, k2_log))]
    parts += [(f"DMCI seed + {name}",
               lambda name=name: phase_video(name, dmci, video[name], dev,
                                             launch_log, k2_log))
              for name in VIDEO]
    parts += [("DCVC-RT", lambda: phase_rt(rt_intra, rt_p, rt, dev,
                                           launch_log, k2_log)),
              ("legacy intra", lambda: phase_legacy_intra(dev, launch_log,
                                                          legacy)),
              ("DCVC-FM", lambda: phase_p_frames(
                  "FM", legacy["IntraNoAR"], fm_p, dev, launch_log)),
              ("DCVC-HEM", lambda: phase_p_frames(
                  "HEM", legacy["IntraNoAR"], hem_p, dev, launch_log)),
              ("DCVC-DC", lambda: phase_p_frames(
                  "DC", legacy["IntraNoAR"], dc_p, dev, launch_log)),
              ("CompressAI / DCVC-2021", lambda: phase_compressai_dcvc(
                  dev, launch_log, compressai, dcvc_p)),
              ("DCVC-TCM", lambda: phase_tcm(dev, launch_log,
                                             compressai["bmshj2018"],
                                             tcm_p))]
    parts += [("training", lambda: phase_train(dev)),
              ("trainers -> codecs",
               lambda: phase_trained_codecs(dev, launch_log, k2_log)),
              ("spatial DMCI", lambda: phase_spatial(dev, launch_log,
                                                     k2_log)),
              ("envelope K2", lambda: phase_envelope_k2(
                  dmci, video["HTS"], dev, launch_log, k2_log))]
    # the training surface of PR 16, in a temporary directory of the
    # checkout: the data scripts' corpus feeds the DDP trainers
    surface = scratch_dir("surface")
    corpus = {}

    def data_scripts():
        corpus["images"], corpus["videos"] = phase_data_scripts(dev, surface)
        return (0, 0, 0)
    parts += [("data scripts", data_scripts),
              ("data-parallel training", lambda: phase_ddp(
                  dev, surface, corpus["images"], corpus["videos"])),
              ("JAX status files", lambda: phase_status(dev, surface,
                                                        launch_log)),
              ("mask decay", lambda: phase_mask_decay(dev))]
    got, want = {}, {}

    def run_part(part, run):
        zero_launch_counts()
        derived = run()     # None: a legacy part, which launches nothing
        want[part] = NO_LAUNCHES if derived is None else derived
        got[part] = launch_counts()
    with launch_log:
        with k2_log:
            for part, run in parts:
                run_part(part, run)
        # parts whose K2 calls are counted, not replayed
        counted_only = [
            ("CLI", lambda: phase_cli(dev, launch_log)),
            ("RT family", lambda: phase_rt_family(dev, launch_log,
                                                  rt_f32)),
            ("FM family", lambda: phase_fm_family(dev, launch_log)),
            ("HEM / DC family", lambda: phase_family_hem_dc(dev,
                                                            launch_log)),
            ("DCVC family", lambda: phase_family_dcvc(dev, launch_log)),
            ("TCM family", lambda: phase_family_tcm(dev, launch_log)),
            ("params.v1", lambda: phase_params_v1(dmci, video["HTS"], dev,
                                                  launch_log)),
            ("image CLI", lambda: phase_image_cli(dev, launch_log)),
            ("workers", lambda: phase_workers(dev, launch_log)),
            ("BD gate", lambda: phase_bd_gate(dev, launch_log)),
            ("symbols", lambda: phase_symbols(dev, launch_log)),
            ("pipeline", lambda: phase_pipeline(
                dev, launch_log, {"DMCI": dmci, "RT intra": rt_intra,
                                  **{n: video[n] for n in VIDEO}}, rt)),
            ("entry points", lambda: phase_entry_points(dev, launch_log))]
        for part, run in counted_only:
            parts.append((part, None))
            run_part(part, run)
    shutil.rmtree(surface)
    phase_traced(dmci, video["HTS"], dev)
    phase_complexity()
    log("main path launches (fused_dcb, fused_dcb_stacked, rans_decode): "
        + "; ".join(f"{part} {got[part]}, derived {want[part]}"
                    for part, _ in parts))
    totals = [sum(g[i] for g in got.values()) for i in range(3)]
    launches = {"fused_dcb": totals[0], "fused_dcb_stacked": totals[1]}
    recorded = collections.Counter()
    for key, n in launch_log.totals().items():
        recorded[key.kind] += n
    k2_counted = sum(got[part][2] for part, _ in counted_only)
    if got != want or recorded != launches \
            or len(k2_log.calls) != totals[2] - k2_counted:
        raise AssertionError(f"main path launches {got}, recorded "
                             f"{dict(recorded)} + {len(k2_log.calls)} K2, "
                             f"derived {want}")
    if min(totals) == 0:
        raise AssertionError("the main path skipped a kernel")
    card_ld = set()
    for label, counts in launch_log.calls:
        if label.startswith("LD ") and "intra frame" not in label:
            card_ld.update(counts)
    if card_ld != ld_shapes:
        raise AssertionError(
            f"LD's K1 shapes on the card {sorted(map(str, card_ld))} differ "
            f"from the model's {sorted(map(str, ld_shapes))}")
    log(f"LD's {len(card_ld)} K1 shapes on the card are the ones derived "
        f"from the model on the meta device: "
        + "; ".join(sorted(map(str, card_ld))))
    card_rt = set()
    for label, counts in launch_log.calls:
        if label.startswith("RT "):
            card_rt.update(counts)
    if card_rt != rt_shapes:
        raise AssertionError(
            f"RT's K1 shapes on the card {sorted(map(str, card_rt))} differ "
            f"from the models' {sorted(map(str, rt_shapes))}")
    log(f"RT's {len(card_rt)} K1 shapes on the card are the ones derived "
        f"from the models on the meta device: "
        + "; ".join(sorted(map(str, card_rt))))

    with torch.inference_mode():
        rows = phase_kernels(dev, launch_log, launches)
        rows.append(phase_k2(k2_log, totals[2]))
    log(f"K2: {len(k2_log.calls)} of the main path's {totals[2]} launches "
        f"replayed and timed; the {k2_counted} of the evaluation entry and "
        f"surface ({', '.join(p for p, _ in counted_only)}) are counted "
        f"only")

    print(json.dumps({"kernels": rows}))
    log(f"smoke total: {time.perf_counter() - t0:.3f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
