"""Drive the PyTorch port's search core, serving embed, PQL pages, text search,
the index build path, the audio path, the image tag and caption path and the
OCR path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. env      the card (nvidia-smi name and power limit), torch, CUDA, nvcc,
            Triton, SQLite and whether it has FTS5;
2. build    the three kernel sources of panoptikon_tpu_torch/csrc/, one nvcc
            each, and the native host codec (csrc/host_codec.cpp, g++), all
            started together (ptxas registers and spills); the host codec
            must build and load; the
            tensor-core instructions (IMMA for mma.sync, IGMMA for wgmma)
            that cuobjdump -sass finds in each form of int8_topk_kernel and
            int8_topk_v2_kernel, which must hold some and no IDP4A: both
            scans' dots run on the tensor cores;
3. kernels  each kernel against its plain PyTorch version on the card, at
            the shapes the main paths give it, timed kernel/plain/plain/
            kernel: mha and mha_qkv bf16 ≤ 2e-2 max abs, every attention
            case timed and the route each takes (tensor cores for bf16 at
            32 ≤ D ≤ 128, D % 16 = 0, else CUDA cores, up to D 512 for
            mha); B3 also at the
            text encoders' shapes (minilm-l6 B 64 × N 128 × H 12 × D 32,
            mpnet-base B 64 × N 512 and B 128 × N 256 × H 12 × D 64),
            key-masked with seeded ragged lengths, q, k, v read in place
            from one fused qkv, on the tensor cores; the tensor-core
            attention's division bit for bit a correctly rounded one over
            every float in [0, 1], ln_quant's int8 code of every float
            equal to a correctly rounded division's, and B2's reciprocal
            square root equal to __frsqrt_rn's at every positive normal
            float; int8 outputs
            (mha_qkv, ln_quant) at most one code apart and at most 0.5 % of
            codes apart; both int8 scans (B1 at Q = 64 with k = 80 and
            k = 1,024 and at Q = 1, B2 at Q = 1,024 and on a ragged corpus
            with +inf sentinel rows), cosine and L2, with
            identical ids and distances within 1e-6; torch._int_mm identical
            to an exact GEMM, and timed with its B operand column-major and
            row-major; F.scaled_dot_product_attention timed beside the bf16
            attention kernels (the library yardstick, never called by the
            port), and torch._int_mm of B1's shapes (the GEMM alone, its
            yardstick); each case's bound on the card (bytes or operations);
4. main     the ViT-B/32 search slice with seeded random bf16 weights: embed
            4,096 images, index them with seeded unit vectors to
            1,048,576 × 512 in a host VectorIndex, build the int8 arm through
            the native host codec (required), build it again through the
            codec's NumPy path (codes equal bit for bit; both timed, and
            build_quant alone in turns native/NumPy/NumPy/native), upload
            it (DeviceIndex), embed 64 text queries and search them top-10,
            and search 256 Gaussian unit queries;
5. check    launch counters of that path (every attention launch on the
            tensor cores), the scan kernel's k·oversample
            candidates at 1,048,576 rows against its plain version for both
            query sets, recall@10 of the 256 queries against the exact fp32
            top-10 (≥ 0.99), the text queries' top-10 against the plain path,
            row validity, and the times, at Q = 256 and at Q = 1;
6. batch    the batched search on phase 4's index: 4,096 Gaussian unit
            queries through DeviceIndex.search (k = 10, oversample 8, so B2
            at k = 80, k_tile 8, tile_n 2048; B1 must not launch); B2's
            candidates against its plain version on all 4,096 queries (in
            chunks of 256), recall@10 of the first 256 against the exact
            fp32 top-10 (≥ 0.99), row validity; QPS, B2's and B1's ms on the
            same 4,096 query codes and on the first 256, 512 and 1,024 of
            them (the B1/B2 crossover, each with its bound and the GEMM
            alone), the candidate overlap of B2 with B1's exact 80, peak
            device memory;
7. int8     the serving embed: ClipImpl(ViT-L-14, precision="int8",
            batch_cap=256) with seeded random weights embeds 1,280 images in
            five predict() calls of 256 (the first calibrates and is left
            out of the rate) and 64 texts; embeddings finite and of unit
            norm; the int8 tower against the bf16 tower on the same
            dequantized weights (min cosine ≥ 0.999 over 64 images of a call
            the calibration never saw, and over 64 of the calibrating
            call); the image
            embeddings, padded with seeded unit rows to 262,144 × 768, are
            searched by the text embeddings through the int8 scan at D = 768
            (kernel path equal to the plain path, tie-aware) and by L2
            (recall@10 ≥ 0.99 against the exact L2 top-10); the launch
            counters of its four kernels are above zero, and every
            attention launch took the tensor-core route;
8. composed the composed two-space RRF of bench.py:214-261 (run after phase
            6): 256 seeded unit queries in each of 500,000 × 512 and
            250,000 × 768, int8_topk_rescored at k = 256 and oversample 4
            (B1 at k·oversample = 1,024), the two candidate lists joined by
            fusion.rrf_fuse_candidates into a top-10; B1 equal to its plain
            version on the first 32 queries of each space, recall@10 of the
            rescored candidates ≥ 0.99 against the exact f32 top-10, the page
            equal to the CPU fusion of the same ids (totals bit for bit); the
            batch's ms and QPS, the fusion's ms, B1 against B2 at k = 1,024
            with the bound and the GEMM alone;
9. pql      a PQL page through the port's Executor.execute: (a) BASELINE #5
            (tools/or3_bench.py): an OR of three RRF leaves over 4M × 512,
            2M × 768 and 1M × 1,024 int8 codes made on the device, with
            recall@10 ≥ 0.99 in each space, the fused path never falling
            back, fused pages equal to the full readback's on 4 queries,
            p50/p95 over 24 sequential queries, the device's idle share
            over them (torch.profiler), 128 queries in 16 threads (QPS, the
            coalescer's batches, each page equal to its solo run), peak
            device memory; (b) one leaf a text embedded by
            ClipImpl("ViT-B-32") through the port's model manager (the
            built-in registry plus that space as a ViT-B-32 clip id), its
            vector equal to ClipImpl.predict's and every attention launch on
            the tensor cores; (c) a DB of 2,000 items seeded through the
            port's db/store.py and db/writer.py (FTS5 required), 13 PQL
            shapes through an Executor on the card and one on the CPU, with
            equal pages;
10. text    text search: (a) the model manager over the built-in registry
            loads textembed/minilm-l6 and textembed/mpnet-base with prewarm
            and embeds 8,192 seeded texts (log-uniform 4-2,048 words, every
            length bucket 32-512, windows past the batch cap) through
            manager.predict in windows of 64: every text's rows (its chunks,
            plus the combined row at four or more), finite, and on 256
            chunks over every length bucket B3 against mha_plain in its
            place (min cosine ≥ 0.999); chunks/s, valid tokens/s, ms per
            window and per full slice of each length bucket; (b) BASELINE
            #4 (tools/e2e_server_bench.py's hybrid_payload) through
            Executor.execute over 1,000,000 text chunks seeded under
            bulk_ingest with live FTS5 and a 1,000,000 × 768 mpnet-base
            space (int8 codes made on the device, recall@10 of the rescored
            candidates ≥ 0.99): an AND of match_text on a "tokNNNN" term and
            text_embeddings whose query is a text embedded through the
            manager; the fused path never falling back, fused = full on 4
            queries, p50/p95 over 24 sequential queries (every embed
            computed), the embed's and the executor phases' ms, the device
            idle share, 128 queries in 16 threads (QPS, the coalescer's
            batches, coalesced = solo), peak device memory; (c) phase 9(c)'s
            DB recipe with its two text spaces filled by the manager's real
            embeddings of its own texts (some long enough to chunk), 9 PQL
            shapes whose text leaves are embedded once on the card, their
            vectors then handed to an Executor on the card and one on the
            CPU, with equal pages;
11. extract the build path (BASELINE #3's text half): (a) 32,768 items with
            OCR text rows (seeded words, log-uniform 4-1,024 a text, so most
            windows of 64 hold a text past mpnet-base's 512-token context)
            seeded under bulk_ingest, textembed/mpnet-base loaded through
            the model manager with prewarm, then DATA_EXTRACTION and
            VECTOR_QUANT_RECONCILE on the port's JobQueue, whose runners
            call run_extraction_job and run_reconcile as the server does:
            texts/s, chunks/s, valid tokens/s, the split into load stall,
            inference, quant reconcile and DB/index writes, the projection
            to 1,000,000 rows, the device's idle share over one manager
            window (profiler) and over the job (CUDA events), B3's launches
            by route, peak memory; a second job finds nothing; (b) every row
            processed, coverage ready at revision 1 over every row, the codes
            equal to the host codec of the vectors stored in SQLite, every
            weight 0.8 × 0.9, every embedding owned by its item (item_data
            ids apart from item ids), a fresh index from index_sync.sync_all
            equal to the built one; (c) 32 stored texts as text_embeddings
            queries through Executor.execute, one at a time: each page holds
            the query's own item, the serving path's rescored candidates
            reach recall@10 ≥ 0.99 against the exact f32 top-10, B1 equal to
            its plain version; (d) 256 rows (short texts and one that
            chunks) built by the job on the card and on the CPU (the
            registry's device "cpu"): equal tables, cosine ≥ 0.999, codes at
            most one apart.
12. audio   the audio path (ROADMAP A.11): (a) 256 WAV files made from the
            seed (tones, chirps, noise bursts; 2-60 s log-uniform; one in
            eight at 44.1 kHz stereo) scanned by jobs/scan.py, then
            whisper/whisper-base (batch 4, 64 tokens) and clap/clap-base
            (batch 8) loaded through the model manager with prewarm, their
            DATA_EXTRACTION jobs and VECTOR_QUANT_RECONCILE on the JobQueue:
            files/s, audio seconds/s and the split of each job, B3's
            launches by route; (b) a transcript for every item (a language,
            0 < confidence ≤ 1, found by FTS5), a unit CLAP vector for every
            item, the CLAP space checked as 11(b); (c) through
            Executor.execute a match_text page on a transcript's token
            (every item holding it), a similar_to page ranking its item
            first, the rescored recall@10 over the CLAP space ≥ 0.99 with B1
            equal to its plain version; (d) one whisper window split into
            log-mel, encode, language probe and decode steps, and the card's
            busy share over it; (e) 8 files through both impls on the card
            and on the CPU (the card's weights copied): CLAP and the encoder
            at cosine ≥ 0.999 a row, language probabilities within 2e-3,
            teacher-forced decoder logits at cosine ≥ 0.999 with the argmax
            equal where the margin is wide and the CPU's free-running tokens
            equal up to the first narrow margin; (f) B3 at the path's four
            shapes (whisper's encoder B 4 × N 1,500, the probe's cross N_q 1
            × N_kv 1,500 and causal N 1, CLAP B 8 × N 320; H 8, D 64) against
            its plain version, timed beside SDPA and the bound.
13. tags    image tags and captions (ROADMAP A.11a-b): (a) 1,024 seeded
            224 × 224 RGB images written as binary PPM files with NumPy and
            scanned by a FOLDER_RESCAN job on the JobQueue (no PIL: no
            thumbnails); (b) tags/vit-tagger (ViT-B/32) through the model
            manager with prewarm, TaggerImpl.tag_arrays over the images'
            normalised pixels in windows of 32, in bf16 and then in int8
            through a user TOML overlay: images/s, ms a window, the busy
            share over a window, peak memory; one call of 100 arrays equal
            to calls of at most 32; int8 raw features against the bf16
            tower on the same dequantized weights at cosine ≥ 0.999 a row on
            images the calibration slice never saw; (c) the bf16 tag maps
            as a SQLite dump keyed by md5, tagmatch/local-dump (the overlay
            gives its dump_path and the md5 handler) through the JobQueue:
            every item the dump's tags, and 16 match_tags pages through
            Executor.execute each holding exactly the items with the tag;
            (d) vlm/caption-base (48 tokens, windows of 8) and
            vlmtags/vlm-tagger (windows of 16) on 256 of the images: every
            item a caption and a tag map, captions/s, a window's vision
            tower and decode split with its steps counted, the busy share;
            (e) 8 images through the tagger and the captioner on the card
            and on the CPU (the card's weights copied): raw features and
            vision tokens at cosine ≥ 0.999, probabilities within 1e-2, mcut
            tag sets equal where the chosen gap is wide, teacher-forced
            decoder steps at cosine ≥ 0.999 with the argmax equal where the
            margin is wide, free-running tokens equal up to the first
            narrow margin, and the same token rows whole through
            whisper._decoder_logits (caption-base's decoder: 768 wide, 2
            heads, so B3 at D 384 on its CUDA-core route, 4 launches
            required) at cosine ≥ 0.999 against the steps; (f) B3 (B 32 ×
            N 50 × H 12 × D 64), B4 (the same, int8 out) and B5 (1,600 ×
            768) against their plain versions with phase 3's limits, on
            the tensor cores, timed beside the bound and, for B3, SDPA.
14. ocr     the OCR path (ROADMAP A.11c): (a) 256 seeded grayscale pages,
            640 px wide with 8-40 lines of rendered digits (most past the
            readers' top bucket of 16 strips), written as binary PGM files
            with NumPy and scanned by a FOLDER_RESCAN job, the first 64
            also into a second DB; (b) doctr/ocr-default (crnn-base, CTC)
            over all 256 and doctr/ocr-attn (attn-base, whisper's decode
            over the same encoder) over the 64, through the model manager
            with prewarm and the JobQueue's run_extraction_job in the
            registry's windows of 16 pages; a registry overlay's impl_dirs
            give the port's OcrImpl a NumPy PGM decode (no PIL here):
            pages/s, each job's split, peak memory; (c) every item its
            item_data row and text equal to a direct read_arrays call in
            the job's windows (or the empty-text placeholder), B3's
            launches equal to the prewarm's and the windows' slices, all on
            the tensor cores; 16 match_text pages on substrings of items'
            texts through Executor.execute, each holding its item and
            exactly the items whose text holds it, equal to the CPU
            executor's; a window's split (segmentation and strip prep,
            copy, encode, head and argmax or decode ms a step, collapse)
            and the busy share; (d) 8 pages' lines through both readers on
            the card and on the CPU (the card's weights copied): features
            and CTC logits at cosine ≥ 0.999, CTC ids equal where the
            margin is wide, teacher-forced decoder steps at cosine ≥ 0.999
            and free-running tokens equal up to the first narrow margin;
            (e) B3 against mha_plain within 2e-2 at the trunk's shape (B
            16 × N 128 × H 4 × D 64, tensor cores) and at D 160, 256, 384
            and 512 (self, causal, cross 48 × 50 and key-masked: the
            captioner decoder's rows; CUDA cores), timed beside SDPA and
            the bound.

Each main path (phases 4-5, 6, 8, 7, 9, 10, 11, 12, 13 and 14) runs with the launch counters (and
the attention wrappers' counts by route) set to zero just before it and
read just after. Then a line with every kernel's record (launches, the
attention kernels' launches by route, error, times, bound, library time),
the nvidia-smi line,
and last ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without CUDA the script exits 1 before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import sqlite3
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SEED = 0
N_IMAGES, IMAGE_BATCH = 4096, 256
N_ROWS, DIM = 1_048_576, 512
N_TEXT, N_GAUSS, K, OVERSAMPLE = 64, 256, 10, 8
EOT = 49407
L14_BATCH, L14_CALLS, L14_ROWS = 256, 5, 262_144
# Kernel checks of phase 3, at the shapes the main paths give each kernel.
ATTN_CASES = {
    # name: (b, n_q, n_kv, h, d, causal, masked)
    "vit_b32_image": (256, 50, 50, 12, 64, False, False),
    "clip_text_causal": (64, 77, 77, 8, 64, True, False),
    "key_masked": (64, 77, 77, 8, 64, False, True),
    "cross": (8, 64, 300, 8, 64, False, False),
    "long_1500": (2, 1500, 1500, 8, 64, False, False),
    "vit_l14_calibration": (256, 257, 257, 16, 64, False, False),
    "head_dim_16": (4, 300, 300, 2, 16, False, False),
}
QKV_CASES = {
    # name: (b, n, h, d, causal, int8 out)
    "vit_l14_image_int8": (256, 257, 16, 64, False, True),
    "vit_l14_image_bf16": (256, 257, 16, 64, False, False),
    "vit_l14_text_int8": (64, 77, 12, 64, True, True),
    "vit_h14_378_bf16": (8, 730, 16, 80, False, False),
}
LN_CASES = {"vit_l14_image": (256 * 257, 1024), "vit_l14_text": (64 * 77, 768),
            "ragged": (1000, 1280)}
INT_MM_SHAPE = (256 * 257, 1024, 3 * 1024)  # the ViT-L/14 qkv GEMM
N_SCAN, Q_SCAN, PLANTED = 65_536, 64, (777, 20_000, 60_000)
Q_SCAN_V2, N_RAGGED = 1024, 10_000  # B2's kernel checks: Q > 512; N not a multiple of 2,048
N_BATCH, PLAIN_CHUNK = 4096, 256  # the batched search; the plain version's query chunk
CROSSOVER_Q = (256, 512, 1024, 4096)  # B1 and B2 timed on the 1M index
# The composed two-space bench (ROADMAP A.5): (rows, dim) of each space, its
# queries and k, and the queries held against B1's plain version.
COMPOSED_SPACES, COMPOSED_Q, COMPOSED_K, COMPOSED_CHECKED = (
    ((500_000, 512), (250_000, 768)), 256, 1024, 32)
COMPOSED_TOPK, COMPOSED_OVERSAMPLE, COMPOSED_PAGE = 256, 4, 10  # bench.py:214-261
# BASELINE #5 (tools/or3_bench.py's defaults): (space, rows, dim, RRF weight)
# of the three spaces, the sequential and concurrent passes, the recall
# queries, and the queries held fused against full.
OR3_SPACES = (("clip/or3", 4_000_000, 512, 1.0), ("tags/or3", 2_000_000, 768, 0.8),
              ("st/or3", 1_000_000, 1024, 0.6))
OR3_SEQ, OR3_THREADS, OR3_CONCURRENT, OR3_RECALL_Q, OR3_PARITY_Q = 24, 16, 128, 32, 4
OR3_CACHE_BUDGET = 16 << 30
PQL_DB_ITEMS = 2000  # phase 9(c)'s seeded DB
# Phase 3's B3 cases at the text encoders' shapes (models/text_embed.py): q,
# k, v the views of one fused qkv, a key mask of seeded ragged lengths.
TEXT_ATTN_CASES = {
    # name: (b, n, h, d)
    "minilm_l6_text": (64, 128, 12, 32),
    "mpnet_base_ctx512": (64, 512, 12, 64),
    "mpnet_base_n256": (128, 256, 12, 64),  # tools/text_embed_kernel_probe.py's shape
}
# Phase 10 (text search): the registry's two text encoders, the texts they
# embed through the model manager (word counts log-uniform in TEXT_WORDS) in
# windows of the registry's default_batch_size, the chunks held against
# mha_plain; BASELINE #4's hybrid page over HYBRID_ROWS text chunks
# (tools/e2e_server_bench.py's recipe) in the mpnet-base space; the DB of
# 10(c) (seed_pql_db's recipe with real embeddings).
TEXT_MODELS = ("textembed/minilm-l6", "textembed/mpnet-base")
TEXT_CACHE_KEY = "smoke"
TEXT_N, TEXT_WINDOW, TEXT_WORDS, TEXT_CHECKED = 8192, 64, (4, 2048), 256
HYBRID_SPACE, HYBRID_ROWS, HYBRID_DIM = "textembed/mpnet-base", 1_000_000, 768
HYBRID_SEQ, HYBRID_THREADS, HYBRID_CONCURRENT, HYBRID_PARITY_Q = 24, 16, 128, 4
TEXT_DB_ITEMS, TEXT_DB_LONG_WORDS = 2000, 2200
# Phase 11 (the build path, BASELINE #3's text half): N_BUILD OCR text rows
# of seeded_texts (word counts log-uniform in BUILD_WORDS: one word is one
# token, so texts past 510 words outrun mpnet-base's 512-token context and
# most windows of 64 hold one that chunks) embedded by BUILD_MODEL through
# the port's JobQueue, run_extraction_job, the finishing reconcile and
# index_sync; item_data ids BUILD_DATA_OFFSET apart from the item ids;
# BUILD_QUERIES stored texts searched through Executor.execute; and
# BUILD_PAIR_ROWS rows built on the card and on the CPU (short texts, words
# log-uniform in BUILD_PAIR_WORDS, and one of BUILD_PAIR_LONG words that
# chunks: the card machine's CPU encodes mpnet-base at a few hundred
# tokens/s).
BUILD_MODEL, BUILD_CACHE_KEY = "textembed/mpnet-base", "build"
N_BUILD, BUILD_WORDS, BUILD_DATA_OFFSET = 32_768, (4, 1024), 1_000_000
BUILD_QUERIES, BUILD_PAIR_ROWS, BUILD_PAIR_WORDS, BUILD_PAIR_LONG = 32, 256, (4, 32), 600
# Phase 12 (audio, ROADMAP A.11): AUDIO_FILES seeded WAV files (seconds
# log-uniform in AUDIO_SECONDS, one in AUDIO_STEREO_EVERY at 44.1 kHz stereo)
# scanned, then transcribed by WHISPER_MODEL and embedded by CLAP_MODEL
# through the JobQueue (the registry's batches, 4 and 8); AUDIO_RECALL_Q
# stored CLAP vectors as recall queries; AUDIO_PAIR_FILES of them through
# both impls on the card and on the CPU, language probabilities within
# AUDIO_PROB_ATOL; B3 at the shapes the path gives it.
AUDIO_FILES, AUDIO_SECONDS, AUDIO_STEREO_EVERY, AUDIO_RECALL_Q = 256, (2.0, 60.0), 8, 32
WHISPER_MODEL, CLAP_MODEL, AUDIO_CACHE_KEY = "whisper/whisper-base", "clap/clap-base", "audio"
AUDIO_PAIR_FILES, AUDIO_PROB_ATOL = 8, 2e-3
AUDIO_ATTN_CASES = {
    # name: (b, n_q, n_kv, h, d, causal, q/k/v views of one fused qkv)
    "whisper_base_encoder": (4, 1500, 1500, 8, 64, False, True),
    "whisper_probe_cross": (4, 1, 1500, 8, 64, False, False),
    "whisper_probe_causal": (4, 1, 1, 8, 64, True, True),
    "clap_base": (8, 320, 320, 8, 64, False, False),
}
# Phase 13 (image tags and captions, ROADMAP A.11a-b): TAG_IMAGES seeded
# TAG_SIZE² RGB images written as binary PPM files and scanned; TAG_MODEL
# through the manager in windows of TAG_WINDOW (its default batch), bf16 and
# int8, one call of TAG_SLICE_CHECK arrays held to calls of at most the batch
# cap; its tag maps as TAGMATCH_MODEL's dump, TAG_QUERIES match_tags pages;
# CAPTION_MODEL and VLM_TAG_MODEL on CAPTION_IMAGES of the arrays;
# TAG_PAIR_IMAGES on the card and on the CPU, probabilities within
# TAG_PROB_ATOL; B3 and B4 at the trunk's attention (B 32 × N 50 × H 12 ×
# D 64), B5 at a window's LayerNorm rows (32 × 50 × 768).
TAG_IMAGES, TAG_SIZE, TAG_WINDOW, TAG_SLICE_CHECK, TAG_QUERIES = 1024, 224, 32, 100, 16
TAG_MODEL, TAGMATCH_MODEL, TAG_CACHE_KEY = "tags/vit-tagger", "tagmatch/local-dump", "tags"
CAPTION_MODEL, VLM_TAG_MODEL, CAPTION_IMAGES = "vlm/caption-base", "vlmtags/vlm-tagger", 256
# Two bf16 ViT-B/32 trunks (the card's, the CPU's) agree at cosine 0.99993;
# the head turns that into probabilities up to 8e-3 apart (PERF.md §6).
TAG_PAIR_IMAGES, TAG_PROB_ATOL = 8, 1e-2
TAG_ATTN_SHAPE, TAG_LN_SHAPE = (32, 50, 12, 64), (32 * 50, 768)
# Phase 14 (OCR, ROADMAP A.11c): OCR_PAGES seeded grayscale pages
# OCR_PAGE_WIDTH wide with OCR_LINES lines each (most past the readers' top
# bucket of 16 strips), written as binary PGM files and scanned; OCR_MODEL
# over every page and OCR_ATTN_MODEL over the first OCR_ATTN_PAGES through
# the JobQueue in the registry's windows of 16 pages; OCR_QUERIES match_text
# pages; OCR_PAIR_PAGES on the card and on the CPU; B3 at the trunk's
# attention (OCR_ATTN_SHAPE: 16 strips × 128 column tokens × 4 heads × 64)
# and past D 128 at the captioner decoder's rows (WIDE_HEAD_DIMS ×
# WIDE_ATTN_CASES: 8 rows of 48 tokens, 2 heads, cross over 50 tokens).
OCR_PAGES, OCR_PAGE_WIDTH, OCR_LINES, OCR_ATTN_PAGES, OCR_QUERIES = 256, 640, (8, 40), 64, 16
OCR_MODEL, OCR_ATTN_MODEL, OCR_CACHE_KEY, OCR_PAIR_PAGES = (
    "doctr/ocr-default", "doctr/ocr-attn", "ocr", 8)
OCR_ATTN_SHAPE, WIDE_HEAD_DIMS = (16, 128, 4, 64), (160, 256, 384, 512)
WIDE_ATTN_CASES = {
    # name: (b, n_q, n_kv, h, causal, key-masked)
    "self": (8, 48, 48, 2, False, False),
    "causal": (8, 48, 48, 2, True, False),
    "cross": (8, 48, 50, 2, False, False),
    "key_masked": (8, 48, 48, 2, False, True),
}
# Published H100 SXM peaks at 700 W (NVIDIA's data sheet, dense): the least
# time a kernel could take is the larger of its operations over the peak of
# their type and its bytes (each input read once, each output written once)
# over the memory rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
LN_OPS_PER_ELEMENT = 9  # two moments (4), normalize (2), affine (2), quantize (1)
WORDS = ("a photo of the red blue green small large dog cat car tree house beach night "
         "city street person two three on in at with near old new bright dark").split()


def scratch_dir() -> Path:
    """build/ beside this script (git-ignored): where the phases' temporary
    DBs and registry files go."""
    path = Path(__file__).resolve().parent / "build"
    path.mkdir(exist_ok=True)
    return path


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(torch, kernel, plain, reps: int = 20) -> tuple[float, float]:
    """Kernel and plain timed in turns (kernel, plain, plain, kernel)."""
    k1 = cuda_ms(torch, kernel, reps)
    p1 = cuda_ms(torch, plain, reps)
    p2 = cuda_ms(torch, plain, reps)
    k2 = cuda_ms(torch, kernel, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def require_codes(torch, got, want, what: str) -> int:
    """int8 outputs: at most one code apart, at most 0.5 % of codes apart.
    Returns the largest code difference."""
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    worst, share = int(diff.max().item()), float((diff > 0).float().mean().item())
    require(worst <= 1 and share <= 5e-3, f"{what}: max code diff {worst}, {share:.2e} differ")
    return worst


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def roofline(ops: float, kind: str, moved: int) -> dict:
    """The bound of one call: operations over the peak of their type, or
    bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = ops / PEAK_OPS_PER_S[kind], moved / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def scan_roofline(args, k: int) -> dict:
    """An int8 scan: 2·Q·N·D int8 operations; reads codes, sumsq, validity
    and query codes, writes (Q, k) f32 distances, int64 rows and bools."""
    codes, _, _, q_codes = args
    q, (n, d) = q_codes.shape[0], codes.shape
    return roofline(2 * q * n * d, "int8", nbytes(*args) + q * k * (4 + 8 + 1))


def gemm_only_ms(torch, args, reps: int = 5) -> float:
    """The yardstick of a scan: torch._int_mm of its query codes by its
    corpus codes (B column-major), int32 out, with no epilogue and no
    selection; timed here, never called by the scans."""
    from panoptikon_tpu_torch.ops import exact

    codes, q_codes = args[0], args[3]
    return cuda_ms(torch, lambda: exact.int_mm(q_codes, codes.t()), reps=reps, warmup=1)


def unit_rows(torch, n: int, dim: int, gen, dev):
    """n seeded unit rows, made 131,072 at a time."""
    parts = []
    for lo in range(0, n, 131_072):
        x = torch.randn((min(131_072, n - lo), dim), generator=gen, device=dev)
        parts.append(x / torch.linalg.norm(x, dim=1, keepdim=True))
    return torch.cat(parts)


def attention_roofline(q, k, v, out, causal=False, mask=None) -> dict:
    """QKᵀ and PV: 4·B·H·N_q·N_kv·D operations (half the keys when causal)."""
    b, nq, h, d = q.shape
    ops = 4 * b * h * nq * k.shape[1] * d * ((nq + 1) / (2 * nq) if causal else 1)
    return roofline(ops, "bf16", nbytes(q, k, v, mask, out))


def sdpa(torch, q, k, v, causal=False, mask=None):
    """F.scaled_dot_product_attention on (B, N, H, D) views: the library
    yardstick of the attention kernels, timed here, never called by the port.
    A key mask becomes the additive −1e9 bias of the kernels."""
    import torch.nn.functional as F

    bias = None
    if mask is not None:
        bias = torch.where(mask, 0.0, -1e9).to(q.dtype)[:, None, None, :]
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), attn_mask=bias, is_causal=causal)
    return out.transpose(1, 2)


def reset_counts(counters) -> None:
    """Launch counts (and the attention wrappers' counts by route) to zero."""
    for fn in counters:
        fn.launches = 0
        if hasattr(fn, "routes"):
            fn.routes = dict.fromkeys(fn.routes, 0)


def read_routes(counters) -> dict:
    return {fn.__name__: dict(fn.routes) for fn in counters if hasattr(fn, "routes")}


def require_tensor_cores(launches, routes, names, what: str) -> None:
    """Every attention launch of a main path took the tensor-core route."""
    for name in names:
        require(routes[name]["cuda_core"] == 0 and routes[name]["tensor_core"] == launches[name],
                f"{what}: {name} launches {launches[name]} by route {routes[name]}")


@contextlib.contextmanager
def not_counted(counters):
    """Launches inside (comparisons with a plain version, timing) leave the
    main path's launch counts, and counts by route, as they were."""
    saved = [(fn.launches, dict(getattr(fn, "routes", {}))) for fn in counters]
    try:
        yield
    finally:
        for fn, (n, routes) in zip(counters, saved):
            fn.launches = n
            if hasattr(fn, "routes"):
                fn.routes = routes


def host_index_build(torch, dev, img_np):
    """Phase 4's host VectorIndex: the image embeddings, seeded unit rows up
    to N_ROWS × DIM (made on the device, 131,072 at a time), then the int8
    arm. Returns (index, scale, seconds)."""
    from panoptikon_tpu_torch.index import VectorIndex

    t0 = time.perf_counter()
    index = VectorIndex()
    index.reserve("clip", N_ROWS, DIM)
    index.add("clip", np.arange(N_IMAGES), np.arange(N_IMAGES), img_np)
    fill_gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    step = 131_072
    for lo in range(N_IMAGES, N_ROWS, step):
        hi = min(lo + step, N_ROWS)
        rows = torch.randn((hi - lo, DIM), generator=fill_gen, device=dev)
        rows = rows / torch.linalg.norm(rows, dim=1, keepdim=True)
        index.add("clip", np.arange(lo, hi), np.arange(lo, hi), rows.cpu().numpy())
    scale = index.build_quant("clip")
    return index, scale, time.perf_counter() - t0


@contextlib.contextmanager
def numpy_codec(codec):
    """The host codec's NumPy path in place of the native library."""
    saved = codec._native
    codec._native = lambda: None
    try:
        yield
    finally:
        codec._native = saved


def int8_embed_path(torch, dev, smi, counters) -> dict:
    """Phase 7: the ViT-L/14 static-int8 embed through ClipImpl.predict, its
    image embeddings indexed and searched by its text embeddings."""
    from panoptikon_tpu_torch.index import VectorIndex
    from panoptikon_tpu_torch.index.device_index import DeviceIndex
    from panoptikon_tpu_torch.models import clip
    from panoptikon_tpu_torch.models.impls import ClipImpl, PredictionInput, npy
    from panoptikon_tpu_torch.ops import codec, exact, int8_scan, scoring

    t0 = time.perf_counter()
    impl = ClipImpl(model_arch="ViT-L-14", precision="int8", batch_cap=L14_BATCH, device=dev)
    impl.load()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = impl.cfg
    size = cfg.image_size

    # 1-3. Five predict() calls of 256 pre-decoded images; the first calibrates.
    rng = np.random.default_rng(SEED + 10)
    img_emb, batch_s, head_pixels = [], [], []
    for _ in range(L14_CALLS):
        pixels = rng.standard_normal((L14_BATCH, size, size, 3), dtype=np.float32)
        inputs = [PredictionInput(data={"pixels": p}) for p in pixels]
        t0 = time.perf_counter()
        out = impl.predict(inputs)
        batch_s.append(time.perf_counter() - t0)
        img_emb.append(np.stack([npy.parse_npy(o) for o in out]))
        head_pixels.append(pixels[:N_TEXT])
    img_emb = np.concatenate(img_emb)
    texts = [" ".join(rng.choice(WORDS, size=rng.integers(2, 12))) for _ in range(N_TEXT)]
    text_inputs = [PredictionInput(data={"text": t}) for t in texts]
    t0 = time.perf_counter()
    out = impl.predict(text_inputs)
    first_text_s = time.perf_counter() - t0
    txt_emb = np.stack([npy.parse_npy(o) for o in out])

    # 4. Finite, unit-norm embeddings of the right shape.
    n_img = L14_CALLS * L14_BATCH
    require(img_emb.shape == (n_img, cfg.embed_dim) and img_emb.dtype == np.float32,
            "int8 image embeddings shape")
    require(txt_emb.shape == (N_TEXT, cfg.embed_dim), "int8 text embeddings shape")
    for name, emb in (("image", img_emb), ("text", txt_emb)):
        require(bool(np.isfinite(emb).all()), f"int8 {name} embeddings finite")
        require(bool((np.abs(np.linalg.norm(emb, axis=1) - 1) < 1e-3).all()),
                f"int8 {name} embeddings unit norm")

    # 5. The int8 tower against the bf16 tower on the same dequantized weights:
    # 64 images of the second call, which the calibration never saw, and 64
    # of the first, calibrating call beside them.
    bf16_cfg = dataclasses.replace(cfg, matmul_precision="bf16")
    cos = {}
    with not_counted(counters):
        for name, call in (("held_out", 1), ("calibration_batch", 0)):
            want = clip.embed_images(impl.params, bf16_cfg,
                                     torch.from_numpy(head_pixels[call]).to(dev)).cpu().numpy()
            lo = call * L14_BATCH
            cos[name] = float(cosines(img_emb[lo:lo + N_TEXT], want).min())
        ids = torch.from_numpy(impl.token_ids(texts)).to(dev)
        want_t = clip.embed_texts(impl.params, bf16_cfg, ids).cpu().numpy()[:N_TEXT]
    require(min(cos.values()) >= 0.999, f"int8 vs bf16 tower: min cosine {cos} < 0.999")
    cos_t = cosines(txt_emb, want_t)

    # Steady-state times: one request at a time, as predict() serves them.
    text_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        impl.predict(text_inputs)
        text_s.append(time.perf_counter() - t0)
    calib_images = torch.from_numpy(head_pixels[0]).to(dev).repeat(L14_BATCH // N_TEXT, 1, 1, 1)
    torch.cuda.synchronize()
    with not_counted(counters):
        t0 = time.perf_counter()
        clip.calibrate_image_scales(impl.params, cfg, calib_images)
        torch.cuda.synchronize()
        calibration_s = time.perf_counter() - t0
    del calib_images

    # 6. The image embeddings in an index padded with seeded unit rows.
    t0 = time.perf_counter()
    index = VectorIndex()
    index.reserve("clip", L14_ROWS, cfg.embed_dim)
    index.add("clip", np.arange(n_img), np.arange(n_img), img_emb)
    fill_gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    fill = torch.randn((L14_ROWS - n_img, cfg.embed_dim), generator=fill_gen, device=dev)
    fill = (fill / torch.linalg.norm(fill, dim=1, keepdim=True)).cpu().numpy()
    index.add("clip", np.arange(n_img, L14_ROWS), np.arange(n_img, L14_ROWS), fill)
    scale = index.build_quant("clip")
    dindex = DeviceIndex(index, "clip", dev)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0

    # 7. Text-to-image search through the scan at D = 768 against the plain path.
    q_txt = torch.from_numpy(txt_emb).to(dev)
    tv, ti, tok = dindex.search(q_txt, K, oversample=OVERSAMPLE)
    args = (dindex.codes, dindex.sumsq, dindex.row_valid, codec.quantize_int8(q_txt, scale))
    with not_counted(counters):
        gv, gi, _ = int8_scan.int8_topk(*args, k=K * OVERSAMPLE)
    pv, pi, _ = int8_scan.int8_topk_plain(*args, k=K * OVERSAMPLE)
    torch.cuda.synchronize()
    scan_err = (gv - pv).abs().max().item()
    require(torch.equal(gi, pi) and scan_err <= 1e-6, "int8_topk at D=768: differs from plain")
    rv, ri, _ = scoring.rescore_candidates(pv, pi, dindex.vectors, q_txt, k=K)
    text_agree = exact.topk_agree(tv.cpu().numpy(), ti.cpu().numpy(), rv.cpu().numpy(),
                                  ri.cpu().numpy(), atol=1e-6)
    require(bool(tok.all().item()) and text_agree,
            "int8 embed: text-to-image top-10 through the kernel differs from the plain path")

    # 8. One L2 search (text and Gaussian unit queries) against the exact L2 top-10.
    gq = torch.randn((N_TEXT, cfg.embed_dim), generator=torch.Generator(device=dev).manual_seed(SEED + 12),
                     device=dev)
    q_l2 = torch.cat([q_txt, gq / torch.linalg.norm(gq, dim=1, keepdim=True)])
    _, li, lok = scoring.int8_topk_rescored(
        dindex.codes, dindex.sumsq, dindex.row_valid, dindex.vectors,
        codec.quantize_int8(q_l2, scale), q_l2, k=K, oversample=OVERSAMPLE, distance="l2",
        scale=scale)
    group_ids = torch.from_numpy(index.snapshot("clip").group_ids).to(dev)
    _, ei, _ = exact.exact_search(dindex.vectors, dindex.row_valid, group_ids, q_l2,
                                  num_groups=L14_ROWS, k=K, distance="l2")
    got_ids, exact_ids = li.cpu().numpy(), ei.cpu().numpy()
    recall_l2 = float(np.mean([len(set(got_ids[i]) & set(exact_ids[i])) / K
                               for i in range(len(got_ids))]))
    require(bool(lok.all().item()) and recall_l2 >= 0.99, f"L2 recall@10 {recall_l2} < 0.99")

    steady = batch_s[1:]
    return {
        "card": smi, "config": "ViT-L-14 int8 static, seeded random weights, ClipImpl.predict",
        "images": n_img, "texts": N_TEXT, "rows": L14_ROWS, "dim": cfg.embed_dim,
        "img_per_s_batch_256": len(steady) * L14_BATCH / sum(steady),
        "predict_s_per_batch_256": steady, "first_predict_s_with_calibration": batch_s[0],
        "image_calibration_s_batch_256": calibration_s,
        "text_ms_per_batch_of_64": 1e3 * sum(text_s) / len(text_s),
        "first_text_predict_s_with_calibration": first_text_s,
        "min_cos_int8_vs_bf16_images_held_out": cos["held_out"],
        "min_cos_int8_vs_bf16_images_calibration_batch": cos["calibration_batch"],
        "min_cos_int8_vs_bf16_texts": float(cos_t.min()),
        "text_top10_equals_plain": text_agree, "int8_topk_max_abs_err": scan_err,
        "l2_recall_at_10": recall_l2, "load_s": load_s, "index_build_and_upload_s": index_s,
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
    }


def batch_path(torch, dev, smi, dindex, group_ids, scale, counters) -> dict:
    """Phase 6: 4,096 Gaussian unit queries through DeviceIndex.search, the
    batch route of int8_topk_rescored (B2 above 512 queries)."""
    from panoptikon_tpu_torch.ops import codec, exact, int8_scan

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    bq = torch.randn((N_BATCH, DIM), generator=gen, device=dev)
    bq = bq / torch.linalg.norm(bq, dim=1, keepdim=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    bv, bi, bok = dindex.search(bq, K, oversample=OVERSAMPLE)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    require(launches["int8_topk_v2"] > 0 and launches["int8_topk"] == 0,
            f"batch: kernel launches {launches}")
    require(tuple(bi.shape) == (N_BATCH, K) and bool(bok.all().item()), "batch: every top-10 valid")
    require(bool(((bi >= 0) & (bi < dindex.size)).all().item()), "batch: rows in range")
    require(bool(dindex.row_valid[bi].all().item()), "batch: rows are valid rows")

    # B2's k·oversample candidates against its plain version on every query;
    # the plain version runs 256 queries at a time (one (4,096 × N) f32
    # surface would take 16 GiB), which gives the same rows: it is per query.
    args = (dindex.codes, dindex.sumsq, dindex.row_valid, codec.quantize_int8(bq, scale))
    kk = K * OVERSAMPLE
    with not_counted(counters):
        cv, ci, cok = int8_scan.int8_topk_v2(*args, k=kk)
    err, same = 0.0, True
    for lo in range(0, N_BATCH, PLAIN_CHUNK):
        hi = lo + PLAIN_CHUNK
        pv, pi, pok = int8_scan.int8_topk_v2_plain(*args[:3], args[3][lo:hi], k=kk)
        same = same and torch.equal(ci[lo:hi], pi) and torch.equal(cok[lo:hi], pok)
        err = max(err, (cv[lo:hi] - pv)[pok].abs().max().item())
    del pv, pi, pok
    require(same, "batch: int8_topk_v2 ids differ from its plain version")
    require(err <= 1e-6, f"batch: int8_topk_v2 max abs dist diff {err} > 1e-6")

    exact_ids = []
    for lo in range(0, PLAIN_CHUNK, 64):
        _, ei, _ = exact.exact_search(dindex.vectors, dindex.row_valid, group_ids, bq[lo:lo + 64],
                                      num_groups=dindex.size, k=K)
        exact_ids.append(ei)
    exact_ids = torch.cat(exact_ids).cpu().numpy()
    got_ids = bi[:PLAIN_CHUNK].cpu().numpy()
    recall = float(np.mean([len(set(exact_ids[i]) & set(got_ids[i])) / K
                            for i in range(PLAIN_CHUNK)]))
    require(recall >= 0.99, f"batch: recall@10 {recall} < 0.99")

    search_ms = cuda_ms(torch, lambda: dindex.search(bq, K, oversample=OVERSAMPLE), reps=3,
                        warmup=1)
    with not_counted(counters):
        _, b1_rows, _ = int8_scan.int8_topk(*args, k=kk)
        # The B1/B2 crossover: both on the first Q of the 4,096 query codes,
        # in turns (B1, B2, B2, B1), beside the bound and the GEMM alone.
        crossover = {}
        for q in CROSSOVER_Q:
            part = (*args[:3], args[3][:q])
            v1, v2 = paired_ms(torch, lambda: int8_scan.int8_topk(*part, k=kk),
                               lambda: int8_scan.int8_topk_v2(*part, k=kk), reps=3)
            crossover[q] = {"b1_ms": v1, "b2_ms": v2, **scan_roofline(part, kk),
                            "gemm_only_ms": gemm_only_ms(torch, part, reps=3)}
        torch.cuda.empty_cache()
    v2_ms, v1_ms = crossover[N_BATCH]["b2_ms"], crossover[N_BATCH]["b1_ms"]
    plain_ms = cuda_ms(torch, lambda: int8_scan.int8_topk_v2_plain(*args[:3], args[3][:PLAIN_CHUNK],
                                                                     k=kk), reps=2, warmup=1)
    overlap = (ci[:, :, None] == b1_rows[:, None, :]).any(-1).float().mean().item()
    return {
        "card": smi, "queries": N_BATCH, "rows": dindex.size, "dim": DIM, "k": K,
        "launches": launches, "recall_at_10_first_256": recall, "int8_topk_v2_max_abs_err": err,
        "search_qps_q4096_k10": N_BATCH / (search_ms / 1e3), "search_ms_q4096": search_ms,
        "int8_topk_v2_1m_q4096_k80_ms": v2_ms, "int8_topk_1m_q4096_k80_ms": v1_ms,
        "crossover_1m_k80": crossover,
        "int8_topk_v2_plain_ms_per_256_queries": plain_ms,
        "candidate_overlap_v2_vs_exact_80": overlap, "peak_device_gib": peak_gib,
        **{"int8_topk_v2_1m_q4096_" + key: value
           for key, value in scan_roofline(args, kk).items()},
    }


def composed_path(torch, dev, smi, counters) -> dict:
    """Phase 8: the composed two-space RRF of bench.py on the port. In each
    space COMPOSED_Q seeded unit queries take int8_topk_rescored's k = 256
    at oversample 4 (B1 at k·oversample = 1,024) over seeded unit rows; the
    two candidate lists join by fusion.rrf_fuse_candidates into a top-10.
    The counts read after the one composed batch are the phase's launches."""
    from panoptikon_tpu_torch.ops import codec, exact, fusion, int8_scan, scoring

    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    spaces = []
    for rows, dim in COMPOSED_SPACES:
        x = unit_rows(torch, rows, dim, gen, dev)
        scale = codec.scale_from_absmax(x.abs().max().item())
        codes = codec.quantize_int8(x, scale)
        q = unit_rows(torch, COMPOSED_Q, dim, gen, dev)
        spaces.append({"x": x, "q": q, "scale": scale, "codes": codes,
                       "sumsq": scoring.row_sumsq_chunked(codes),
                       "valid": torch.ones(rows, dtype=torch.bool, device=dev),
                       "q_codes": codec.quantize_int8(q, scale)})
        kk = COMPOSED_TOPK * COMPOSED_OVERSAMPLE
        require(scoring.candidate_route(COMPOSED_Q, rows, kk) == "b1",
                f"composed: the candidate route at {rows} rows is not B1")
    (n1, _), (n2, _) = COMPOSED_SPACES
    ones = torch.ones(2, dtype=torch.float32, device=dev)

    def composed():
        ranked = [scoring.int8_topk_rescored(
            s["codes"], s["sumsq"], s["valid"], s["x"], s["q_codes"], s["q"], k=COMPOSED_TOPK,
            oversample=COMPOSED_OVERSAMPLE, distance="cosine", scale=s["scale"]) for s in spaces]
        cand = torch.stack([ranked[0][1], ranked[1][1] * (n1 // n2)]).to(torch.int32)
        return ranked, cand, fusion.rrf_fuse_candidates(cand, ones, k=COMPOSED_PAGE)

    torch.cuda.synchronize()
    reset_counts(counters)
    ranked, cand, (totals, ids) = composed()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    require(launches["int8_topk"] > 0 and launches["int8_topk_v2"] == 0,
            f"composed: kernel launches {launches}")
    require(tuple(ids.shape) == (COMPOSED_Q, COMPOSED_PAGE) and bool(torch.isfinite(totals).all().item()),
            "composed: a finite top-10 for every query")

    out, err = {}, 0.0
    with not_counted(counters):
        # The page off the card against the port's fusion on the CPU from the
        # same candidate ids: ids equal, totals bit for bit.
        cpu_totals, cpu_ids = fusion.rrf_fuse_candidates(cand.cpu(), ones.cpu(), k=COMPOSED_PAGE)
        page_equal = torch.equal(ids.cpu(), cpu_ids) and torch.equal(totals.cpu(), cpu_totals)
        require(page_equal, "composed: the fused page differs from the CPU fusion of the same ids")
        for s, (rv, ri, rok), (rows, dim) in zip(spaces, ranked, COMPOSED_SPACES):
            args = (s["codes"], s["sumsq"], s["valid"], s["q_codes"])
            gv, gi, gok = int8_scan.int8_topk(*args, k=COMPOSED_K)
            pv, pi, pok = int8_scan.int8_topk_plain(*args[:3], args[3][:COMPOSED_CHECKED], k=COMPOSED_K)
            torch.cuda.synchronize()
            n_ok = COMPOSED_CHECKED
            require(torch.equal(gi[:n_ok], pi) and torch.equal(gok[:n_ok], pok),
                    f"int8_topk at {rows} x {dim}, k {COMPOSED_K}: ids differ from plain")
            space_err = (gv[:n_ok] - pv).abs().max().item()
            require(space_err <= 1e-6, f"int8_topk at {rows} x {dim}: max abs dist diff {space_err}")
            err = max(err, space_err)
            # recall@10 of the rescored candidates against the exact f32 top-10.
            _, ei, _ = exact.topk_ascending(exact.pairwise_distance(s["x"], s["q"]), s["valid"], K)
            got, want = ri[:, :K].cpu().numpy(), ei.cpu().numpy()
            recall = float(np.mean([len(set(got[i]) & set(want[i])) / K for i in range(COMPOSED_Q)]))
            require(bool(rok.all().item()) and recall >= 0.99,
                    f"composed: recall@10 {recall} < 0.99 at {rows} x {dim}")
            b1_ms, b2_ms = paired_ms(torch, lambda: int8_scan.int8_topk(*args, k=COMPOSED_K),
                                     lambda: int8_scan.int8_topk_v2(*args, k=COMPOSED_K), reps=5)
            out[f"{rows}x{dim}"] = {
                "int8_topk_ms": b1_ms, "int8_topk_v2_ms": b2_ms,
                **scan_roofline(args, COMPOSED_K), "gemm_only_ms": gemm_only_ms(torch, args),
                "int8_topk_max_abs_err": space_err, "recall_at_10": recall}
        composed_ms = cuda_ms(torch, composed, reps=5, warmup=1)
        fusion_ms = cuda_ms(torch, lambda: fusion.rrf_fuse_candidates(cand, ones, k=COMPOSED_PAGE),
                            reps=20)
    del spaces, ranked
    torch.cuda.empty_cache()
    return {"card": smi, "queries": COMPOSED_Q, "k": COMPOSED_TOPK, "oversample": COMPOSED_OVERSAMPLE,
            "page": COMPOSED_PAGE, "launches": launches, "spaces": out,
            "page_equals_cpu_fusion": page_equal, "composed_ms": composed_ms,
            "composed_qps": COMPOSED_Q / (composed_ms / 1e3), "rrf_fuse_candidates_ms": fusion_ms,
            "int8_topk_max_abs_err": err}


class _Snap:
    """A space snapshot stand-in (tools/or3_bench.py): metadata on the host,
    the codes already on the device in the executor's cache."""

    def __init__(self, n, dim, scale, generation=1):
        self.generation, self.dim, self.scale = generation, dim, scale
        self.size = self.capacity = self.num_groups = n
        self.group_ids = np.arange(n, dtype=np.int32)
        self.row_valid = np.ones(n, dtype=bool)
        self.weights = np.ones(n, dtype=np.float32)
        self.row_ids = np.arange(1, n + 1, dtype=np.int64)
        self.quant_ready = True
        self.codes = self.vectors = None


class _Index:
    """The index stand-in: snapshots by space, slot i holds item i + 1."""

    def __init__(self):
        self.snaps = {}

    def snapshot(self, space):
        return self.snaps[space]

    def item_id_of_groups(self, space, slots):
        return np.asarray(slots, dtype=np.int64) + 1


def _or3_base(n):
    """A synthetic file-entity BaseSnapshot of n files, one per item."""
    from panoptikon_tpu_torch.db.epochs import EPOCHS
    from panoptikon_tpu_torch.pql.executor import BaseSnapshot

    cols = {
        "file_id": np.arange(1, n + 1, dtype=np.int64),
        "item_id": np.arange(1, n + 1, dtype=np.int64),
        "sha256": np.full(n, "00" * 32, dtype=object),
        "path": np.full(n, "/m/x.png", dtype=object),
        "filename": np.full(n, "x.png", dtype=object),
        "last_modified": np.full(n, "2026-01-01T00:00:00", dtype=object),
        "md5": np.full(n, "0" * 32, dtype=object),
        "type": np.full(n, "image/png", dtype=object),
        "size": np.full(n, 1000.0), "width": np.full(n, 640.0), "height": np.full(n, 480.0),
        "duration": np.full(n, np.nan), "audio_tracks": np.zeros(n), "video_tracks": np.zeros(n),
        "subtitle_tracks": np.zeros(n), "blurhash": np.full(n, "", dtype=object),
        "time_added": np.full(n, "2026-01-01T00:00:00", dtype=object),
    }
    return BaseSnapshot(entity="file", epoch=EPOCHS.index_epoch("or3"), columns=cols, n=n)


def _or3_space(torch, dev, n, dim, seed, counters):
    """One space's int8 codes made on the device from seeded unit rows, and
    recall@10 against the exact f32 top-10 while the f32 rows are still
    there: of the int8 top-10 itself (k 10, oversample 4, no rescore, as
    or3_bench measures it; its TPU run recorded 0.9625-0.975, BENCH_r05.json)
    and of the serving path's, the same candidates rescored in f32; and B1 at
    that candidate shape (k 40) held to its plain version on the same inputs
    (ids equal, distances within 1e-6), its time and the plain version's,
    beside its bound and the GEMM alone (torch._int_mm, its library
    yardstick). Returns (codes, sumsq, scale, {"int8": recall, "rescored":
    recall, "b1_k40_max_abs_err": err, "b1_k40_ms": ms, "b1_k40_plain_ms": ms,
    "b1_k40_bound_ms": ms, "b1_k40_bound_by": ..., "b1_k40_gemm_only_ms": ms})."""
    from panoptikon_tpu_torch.ops import codec, exact, int8_scan, scoring

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = unit_rows(torch, n, dim, gen, dev)
    scale = codec.scale_from_absmax(x.abs().max().item())
    codes = torch.cat([codec.quantize_int8(x[lo:lo + 524_288], scale) for lo in range(0, n, 524_288)])
    sumsq = scoring.row_sumsq_chunked(codes)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    q = unit_rows(torch, OR3_RECALL_Q, dim, gen, dev)
    qc = codec.quantize_int8(q, scale)
    _, want, _ = exact.topk_ascending(exact.pairwise_distance(x, q), valid, K)
    want = want.cpu().numpy()
    recall = {}
    for name, args, rescore in (("int8", (codes, qc, qc), False), ("rescored", (x, qc, q), True)):
        _, got, _ = scoring.int8_topk_rescored(codes, sumsq, valid, *args, k=K, oversample=4,
                                               distance="cosine", scale=scale, rescore=rescore)
        got = got.cpu().numpy()
        recall[name] = float(np.mean([len(set(got[i]) & set(want[i])) / K
                                      for i in range(OR3_RECALL_Q)]))
    del x
    with not_counted(counters):
        args = (codes, sumsq, valid, qc)
        gv, gi, gok = int8_scan.int8_topk(*args, k=4 * K)
        pv, pi, pok = int8_scan.int8_topk_plain(*args, k=4 * K)
        torch.cuda.synchronize()
        require(torch.equal(gi, pi) and torch.equal(gok, pok),
                f"int8_topk at {n} x {dim}, k {4 * K}: ids differ from plain")
        recall["b1_k40_max_abs_err"] = (gv - pv).abs().max().item()
        require(recall["b1_k40_max_abs_err"] <= 1e-6,
                f"int8_topk at {n} x {dim}: max abs dist diff {recall['b1_k40_max_abs_err']}")
        recall["b1_k40_ms"], recall["b1_k40_plain_ms"] = paired_ms(
            torch, lambda: int8_scan.int8_topk(*args, k=4 * K),
            lambda: int8_scan.int8_topk_plain(*args, k=4 * K), reps=5)
        recall.update({"b1_k40_" + key: value for key, value in scan_roofline(args, 4 * K).items()})
        recall["b1_k40_gemm_only_ms"] = gemm_only_ms(torch, args)
    return codes, sumsq, scale, recall


def _b64(vec) -> str:
    import base64

    from panoptikon_tpu_torch.utils import npy

    return base64.standard_b64encode(npy.serialize_npy(np.asarray(vec, np.float32))).decode()


def _pages(results) -> list:
    return [r["file_id"] for r in results]


def busy_share(torch, fn) -> tuple[float, float]:
    """Run ``fn`` under the profiler: (wall seconds, the share of that wall
    in which at least one kernel or copy ran on the card)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -np.inf
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    require(spans, "pql: the profiler saw no device activity")
    return wall, busy / 1e6 / wall


def or3_path(torch, dev, smi, counters):
    """Phase 9(a): BASELINE #5 (tools/or3_bench.py) through the port's
    Executor.execute: an OR of three image_embeddings leaves with rrf
    {k 60, weight 1.0 / 0.8 / 0.6} over 4M × 512, 2M × 768 and 1M × 1,024
    int8 codes made on the device, the executor's device cache filled with
    them, page size 10. Returns (the phase's record, the executor)."""
    import threading
    import types

    from panoptikon_tpu_torch.pql import model as pql
    from panoptikon_tpu_torch.pql.executor import Executor

    index = _Index()
    ex = Executor(types.SimpleNamespace(name="or3"), index, manager=None, device=str(dev))
    ex.device_cache_budget = OR3_CACHE_BUDGET
    torch.cuda.reset_peak_memory_stats()
    recalls, t0 = {}, time.perf_counter()
    for seed, (space, n, dim, _) in enumerate(OR3_SPACES, start=SEED + 30):
        codes, sumsq, scale, recalls[space] = _or3_space(torch, dev, n, dim, seed, counters)
        snap = _Snap(n, dim, scale)
        index.snaps[space] = snap
        key = (space, snap.generation, True)
        with ex._cache_lock:
            ex._device_cache[key] = {
                "corpus": codes, "sumsq": sumsq,
                "group_ids": torch.arange(n, dtype=torch.int32, device=dev),
                "weights": torch.ones(n, dtype=torch.float32, device=dev),
                "row_valid": torch.ones(n, dtype=torch.bool, device=dev)}
            ex._device_cache_bytes[key] = codes.numel()
        torch.cuda.empty_cache()
    require(min(r["rescored"] for r in recalls.values()) >= 0.99,
            f"or3: recall@10 of the rescored int8 candidates against f32 {recalls}")
    build_s = time.perf_counter() - t0
    n1 = OR3_SPACES[0][1]
    ex._base_cache["file"] = _or3_base(n1)

    def fail_materialize(*a, **k):
        raise RuntimeError("the fused three-space OR fell back to the full readback")

    ex._materialize_deferred = fail_materialize
    rng = np.random.default_rng(SEED + 11)

    def payload():
        leaves = []
        for space, _, dim, weight in OR3_SPACES:
            v = rng.standard_normal(dim).astype(np.float32)
            leaves.append({"image_embeddings": {"query": _b64(v / np.linalg.norm(v)), "model": space,
                                                "embed": None, "index": "quant"},
                           "row_n": True, "priority": 5, "rrf": {"k": 60, "weight": weight}})
        return {"query": {"or_": leaves}, "page_size": 10}

    def run(p):
        return ex.execute(pql.PqlQuery.from_json(p))

    t0 = time.perf_counter()
    r = run(payload())
    warm_s = time.perf_counter() - t0
    require(r.count == n1 and len(r.results) == 10 and r.metrics.path == "fused",
            f"or3: count {r.count}, {len(r.results)} results, path {r.metrics.path}")

    # Fused against the full readback on OR3_PARITY_Q queries.
    parity = [payload() for _ in range(OR3_PARITY_Q)]
    fused = [_pages(run(p).results) for p in parity]
    ex._materialize_deferred = type(ex)._materialize_deferred.__get__(ex)
    ex.enable_fused = False
    t0 = time.perf_counter()
    full = [_pages(run(p).results) for p in parity]
    full_s = (time.perf_counter() - t0) / OR3_PARITY_Q
    ex.enable_fused = True
    ex._materialize_deferred = fail_materialize
    require(fused == full, f"or3: fused pages differ from the full readback: {fused} vs {full}")

    # Sequential latency, then the same pass under the profiler.
    lats = []
    for _ in range(OR3_SEQ):
        p = payload()
        t0 = time.perf_counter()
        run(p)
        lats.append(time.perf_counter() - t0)
    lats.sort()
    seq = [payload() for _ in range(OR3_SEQ)]
    prof_wall, busy = busy_share(torch, lambda: [run(p) for p in seq])

    # Concurrent: two warm rounds, then OR3_CONCURRENT queries in OR3_THREADS threads.
    def threaded(batch):
        out, errs = [None] * len(batch), []

        def drive(idx):
            try:
                for i in idx:
                    out[i] = _pages(run(batch[i]).results)
            except Exception as exc:  # noqa: BLE001 - re-raised below
                errs.append(exc)

        ts = [threading.Thread(target=drive, args=(range(t, len(batch), OR3_THREADS),))
              for t in range(OR3_THREADS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errs:
            raise errs[0]
        return out

    for _ in range(2):
        threaded([payload() for _ in range(OR3_THREADS)])
    batch = [payload() for _ in range(OR3_CONCURRENT)]
    co0 = ex._scan_coalescer.stats()
    t0 = time.perf_counter()
    concurrent = threaded(batch)
    wall = time.perf_counter() - t0
    co1 = ex._scan_coalescer.stats()
    solo = [_pages(run(p).results) for p in batch]
    require(concurrent == solo, "or3: a coalesced page differs from its solo run")
    # Where a solo query's host time goes: the executor's phase timers.
    ex.debug_timing = True
    phases = {}
    for _ in range(OR3_SEQ):
        for name, sec in run(payload()).metrics.phases.items():
            phases[name] = phases.get(name, 0.0) + 1e3 * sec / OR3_SEQ
    ex.debug_timing = False
    dispatches, queries = co1["dispatches"] - co0["dispatches"], co1["queries"] - co0["queries"]
    disp_ms = co1["dispatch_ms_total"] - co0["dispatch_ms_total"]
    coll_ms = co1["collect_ms_total"] - co0["collect_ms_total"]
    return {
        "card": smi, "spaces": {s: {"rows": n, "dim": d, "rrf_weight": w} for s, n, d, w in OR3_SPACES},
        "codes_gib": sum(n * d for _, n, d, _ in OR3_SPACES) / 2**30,
        "per_space_recall_at_10_and_b1": recalls, "build_s": build_s, "warm_s": warm_s,
        "parity_queries": OR3_PARITY_Q, "fused_equals_full": True, "full_path_s_per_query": full_s,
        "p50_ms": 1e3 * lats[len(lats) // 2],
        "p95_ms": 1e3 * lats[min(len(lats) - 1, int(len(lats) * 0.95))],
        "sequential_ms": [1e3 * t for t in lats],
        "profiled_sequential_s": prof_wall, "device_busy_share": busy, "device_idle_share": 1 - busy,
        "concurrent_qps": OR3_CONCURRENT / wall, "concurrent_wall_s": wall,
        "coalesced_equals_solo": True,
        "coalescer": {"dispatches": dispatches, "queries": queries, "max_batch": co1["max_batch"],
                      "mean_batch": queries / dispatches if dispatches else 0.0},
        "breakdown_ms": {"wall_total": 1e3 * wall, "dispatch_total": disp_ms, "collect_total": coll_ms,
                         "host_and_wait_total": max(0.0, 1e3 * wall - disp_ms - coll_ms)},
        "executor_phase_ms": phases, "rank_join_ms": rank_join_ms(torch, dev, ex),
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
    }, ex


def rank_join_ms(torch, dev, ex) -> dict:
    """The device work of phase 9(a)'s query, op by op, at one query and at
    a coalesced batch of OR3_THREADS: each space's surface
    (scoring.grouped_scores on the cached codes), and at the 4M space the
    rank join's plain torch ops — the two stable argsorts, the slot→item
    min-scatter (the path a non-contiguous map takes; or3's map is
    contiguous, a copy), the (B, n_items) top-kk on packed keys at the
    fused path's first kk — then the whole join of the three spaces."""
    from panoptikon_tpu_torch.ops import codec, fusion, scoring
    from panoptikon_tpu_torch.pql import fused

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    n_items = fused._round_pow2(OR3_SPACES[0][1] + 1)
    out = {}
    for b in (1, OR3_THREADS):
        surfs, ms = [], {}
        for space, n, dim, _ in OR3_SPACES:
            arrays = ex._device_cache[(space, 1, True)]
            q = codec.quantize_int8(unit_rows(torch, b, dim, gen, dev), ex.index.snapshot(space).scale)

            def surface():
                return scoring.grouped_scores(
                    arrays["corpus"], arrays["sumsq"], arrays["row_valid"], arrays["group_ids"], q,
                    num_groups=n, scale=ex.index.snapshot(space).scale, chunk_rows=32768,
                    identity=True)[:2]

            ms[f"surface_{space}"] = cuda_ms(torch, surface, reps=5, warmup=1)
            surfs.append(surface())
        key, valid = surfs[0]
        key = torch.where(valid, key, torch.inf)
        order = torch.argsort(key, dim=-1, stable=True)
        rank = fusion._ranks(key, valid)
        items = torch.arange(1, key.shape[1] + 1, dtype=torch.int32, device=dev)
        total = torch.rand((b, n_items), generator=gen, device=dev)
        ms["argsort_keys_4m"] = cuda_ms(torch, lambda: torch.argsort(key, dim=-1, stable=True), reps=5)
        ms["argsort_order_4m"] = cuda_ms(torch, lambda: torch.argsort(order, dim=-1, stable=True), reps=5)
        ms["scatter_min_4m"] = cuda_ms(torch, lambda: fusion._item_ranks(rank, items, n_items, None), reps=5)
        ms["contiguous_copy_4m"] = cuda_ms(torch, lambda: fusion._item_ranks(rank, items, n_items, 1), reps=5)
        ms["topk_kk128_n_items"] = cuda_ms(torch, lambda: fusion._largest_k(total, fused.SHALLOW_KK), reps=5)
        weights = torch.tensor([[w for *_, w in OR3_SPACES]] * b, device=dev)
        ks = torch.full((b, len(OR3_SPACES)), 60.0, device=dev)
        maps = [torch.arange(1, n + 1, dtype=torch.int32, device=dev) for _, n, _, _ in OR3_SPACES]
        ms["rank_join_3_spaces"] = cuda_ms(torch, lambda: fusion.rank_join_topk_batch(
            tuple(s[0] for s in surfs), tuple(s[1] for s in surfs), tuple(maps), weights, ks,
            kk=fused.SHALLOW_KK, n_items=n_items, contig_offsets=(1, 1, 1)), reps=5)
        out[f"b{b}"] = ms
        del surfs, key, valid, order, rank, total
        torch.cuda.empty_cache()
    return out


def text_leaf_path(torch, dev, smi, ex, counters) -> dict:
    """Phase 9(b): phase 9(a)'s query with its clip leaf a text, embedded by
    ClipImpl("ViT-B-32", precision="bf16") through the model manager on the
    way in (pql/preprocess.py), the text tower's attention on kernel B3. The
    manager's registry is the built-in one with the leaf's space added as a
    ViT-B-32 id of its clip group."""
    import tempfile

    space = OR3_SPACES[0][0]
    group, _, name = space.partition("/")
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as root:
        ex.manager = text_manager(f'[group.{group}.inference_ids.{name}]\n'
                                  'config.model_arch = "ViT-B-32"\nconfig.precision = "bf16"\n', root)
        try:
            return _text_leaf(torch, ex, smi, counters, space)
        finally:
            ex.manager.shutdown()
            ex.manager = None


def _text_leaf(torch, ex, smi, counters, space) -> dict:
    from panoptikon_tpu_torch.models.impls import PredictionInput, npy
    from panoptikon_tpu_torch.pql import model as pql
    from panoptikon_tpu_torch.pql import preprocess

    preprocess.EMBED_CACHE.clear()
    text = "a photo of a red car near the beach at night"
    rng = np.random.default_rng(SEED + 12)
    leaves = [{"image_embeddings": {"query": text, "model": space, "embed": {"cache_key": "smoke"},
                                    "index": "quant"},
               "row_n": True, "priority": 5, "rrf": {"k": 60, "weight": OR3_SPACES[0][3]}}]
    for other, _, dim, weight in OR3_SPACES[1:]:
        v = rng.standard_normal(dim).astype(np.float32)
        leaves.append({"image_embeddings": {"query": _b64(v / np.linalg.norm(v)), "model": other,
                                            "embed": None, "index": "quant"},
                       "row_n": True, "priority": 5, "rrf": {"k": 60, "weight": weight}})
    query = pql.PqlQuery.from_json({"query": {"or_": leaves}, "page_size": 10})
    t0 = time.perf_counter()
    res = ex.execute(query)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    require(len(res.results) == 10 and res.metrics.path == "fused", "text leaf: a fused page of 10")
    impl = ex.manager._models[space].model
    require(type(impl).__name__ == "ClipImpl" and impl.arch == "ViT-B-32",
            f"text leaf: the manager loaded {impl!r}")
    vec = query.query.or_[0].image_embeddings._embedding
    with not_counted(counters):
        want = npy.parse_npy(impl.predict([PredictionInput(data={"text": text})])[0])
    require(vec.shape == (512,) and np.array_equal(vec, want),
            "text leaf: the leaf's vector differs from ClipImpl.predict's")
    t0 = time.perf_counter()
    ex.execute(pql.PqlQuery.from_json({"query": {"or_": leaves}, "page_size": 10}))
    cached_s = time.perf_counter() - t0
    return {"card": smi, "text": text, "manager_loaded": ex.manager.loaded_models(),
            "first_query_s_with_load_and_embed": first_s,
            "query_s_embedding_cached": cached_s, "embed_cache": preprocess.EMBED_CACHE.stats()}


def seed_pql_db(root, n_items: int, seed: int, manager=None):
    """A small DB seeded through the port's db/store.py and db/writer.py as
    tools/pql_equivalence.py seeds its own: every item a file and a 512-d
    clip row; every other item one to three OCR text rows (FTS), each with
    a row in two text-embedding spaces (384-d and 768-d); every third item
    tags. Returns (db, writer, index) with the index's int8 arms built.

    With a model ``manager`` the two text spaces are TEXT_MODELS, filled by
    the manager's embeddings of the DB's own texts (every 25th text long
    enough to chunk, up to TEXT_DB_LONG_WORDS words); each row a text's
    embedding gives is an item_data of its own, the text row its source,
    as jobs/extraction.py stores them. Without one they hold seeded unit
    rows (phase 9(c))."""
    from panoptikon_tpu_torch.db import store
    from panoptikon_tpu_torch.db.connection import Database
    from panoptikon_tpu_torch.db.writer import IndexWriter
    from panoptikon_tpu_torch.index import VectorIndex

    rng = np.random.default_rng(seed)
    db = Database(root, "smoke")
    writer = IndexWriter(db)
    text_spaces = ("st/smoke", "mpnet/smoke") if manager is None else TEXT_MODELS
    dims = {"clip/smoke": 512, text_spaces[0]: 384, text_spaces[1]: 768}
    spaces = {name: ([], [], []) for name in dims}
    mimes = ("image/png", "image/jpeg", "video/mp4", "application/pdf")
    words = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta")
    texts = []  # (item, text row id, text), embedded after the unit

    def unit(conn):
        sid = {name: store.upsert_setter(conn, name)
               for name in ("clip/smoke", "ocr/smoke", "tags/smoke", *text_spaces)}

        def embed(item, space, source_id=None, idx=0):
            v = rng.normal(size=dims[space]).astype(np.float32)
            v /= np.linalg.norm(v)
            did = store.insert_item_data(conn, item, sid[space], "clip" if space == "clip/smoke"
                                         else "text-embedding", idx=idx, source_id=source_id)
            store.insert_embedding(conn, did, v)
            for part, value in zip(spaces[space], (item, did, v)):
                part.append(value)

        for i in range(n_items):
            sha = f"{i:08x}" * 8
            item = store.upsert_item(conn, sha, f"{i:08x}" * 4, mimes[i % 4],
                                     size=int(rng.integers(100, 10_000)),
                                     width=int(rng.integers(10, 4000)), height=int(rng.integers(10, 4000)))
            store.upsert_file(conn, item, sha, f"/corpus/d{i % 7}/f{i:05d}.bin",
                              f"2026-{1 + i % 12:02d}-{1 + i % 28:02d}T00:00:00")
            embed(item, "clip/smoke")
            if i % 2 == 0:
                for ci in range(1 + i % 3):
                    tdid = store.insert_item_data(conn, item, sid["ocr/smoke"], "text", idx=ci)
                    text = " ".join(rng.choice(words, size=int(rng.integers(3, 8)))) + f" token{i}c{ci}"
                    if manager is not None and len(texts) % 25 == 0:
                        n_long = int(rng.integers(600, TEXT_DB_LONG_WORDS))
                        text += " " + " ".join(rng.choice(words, size=n_long))
                    store.insert_extracted_text(conn, tdid, text, language="en",
                                                confidence=float(rng.uniform(0.3, 1.0)),
                                                language_confidence=float(rng.uniform(0.5, 1.0)))
                    if manager is None:
                        embed(item, "st/smoke", source_id=tdid, idx=ci)
                        embed(item, "mpnet/smoke", source_id=tdid, idx=ci)
                    else:
                        texts.append((item, tdid, text))
            if i % 3 == 0:
                gdid = store.insert_item_data(conn, item, sid["tags/smoke"], "tags")
                for tag in rng.choice(("cat", "dog", "tree", "car", "sky"), size=int(rng.integers(1, 4)),
                                      replace=False):
                    store.tag_item(conn, gdid, item, store.upsert_tag(conn, "general", str(tag)),
                                   float(rng.uniform(0.2, 1.0)))
        return sid

    sid = writer.call(unit)
    if manager is not None:
        from panoptikon_tpu_torch.models.impls import PredictionInput, npy

        rows = {}
        for model in TEXT_MODELS:
            rows[model] = []
            for lo in range(0, len(texts), TEXT_WINDOW):
                out = manager.predict(model, [PredictionInput(data={"text": t})
                                              for _, _, t in texts[lo:lo + TEXT_WINDOW]],
                                      cache_key=TEXT_CACHE_KEY, lru_size=len(TEXT_MODELS))
                rows[model].extend(npy.parse_npy_matrix(o) for o in out)

        def embed_rows(conn):
            for model in TEXT_MODELS:
                for (item, tdid, _), matrix in zip(texts, rows[model]):
                    for r, v in enumerate(matrix):
                        did = store.insert_item_data(conn, item, sid[model], "text-embedding",
                                                     idx=r, source_id=tdid)
                        store.insert_embedding(conn, did, v)
                        for part, value in zip(spaces[model], (item, did, v)):
                            part.append(value)

        writer.call(embed_rows)
    index = VectorIndex(chunk_rows=1024)
    for name, (items, dids, vecs) in spaces.items():
        index.add(name, np.array(items), np.array(dids), np.stack(vecs))
        index.build_quant(name)
    return db, writer, index


def pql_db_shapes(index) -> dict:
    """Phase 9(c)'s PQL shapes over seed_pql_db's DB: name → payload."""
    def leaf(field, space, row, *, arm="quant", **extra):
        v = index.snapshot(space).vectors[row]
        return {field: {"query": _b64(v + 0.01), "model": space, "embed": None, "index": arm, **extra}}

    rrf = {"row_n": True, "priority": 5}
    return {
        "metadata": {"query": {"match": {"gt": {"size": 5000}}},
                     "order_by": [{"order_by": "size", "order": "desc"}], "page_size": 50},
        "fts": {"query": {"match_text": {"match": '"gamma"'}}, "page_size": 100},
        "tags": {"query": {"match_tags": {"tags": ["cat", "dog"], "match_any": True}}, "page_size": 100},
        "semantic": {"query": leaf("image_embeddings", "clip/smoke", 7), "page_size": 20},
        "semantic_exact": {"query": leaf("image_embeddings", "clip/smoke", 8, arm="exact"),
                           "page_size": 20},
        "scoped_semantic": {"query": {"and_": [{"match": {"eq": {"type": "image/png"}}},
                                               leaf("image_embeddings", "clip/smoke", 9)]},
                            "page_size": 20},
        "and_rrf": {"query": {"and_": [
            {**leaf("text_embeddings", "st/smoke", 3), **rrf, "rrf": {"k": 60, "weight": 1.0}},
            {**leaf("text_embeddings", "mpnet/smoke", 5), **rrf, "rrf": {"k": 30, "weight": 0.5}}]},
            "page_size": 20},
        "or_rrf": {"query": {"or_": [
            {**leaf("image_embeddings", "clip/smoke", 11), **rrf, "rrf": {"k": 60, "weight": 1.0}},
            {**leaf("text_embeddings", "st/smoke", 4), **rrf, "rrf": {"k": 60, "weight": 0.8}}]},
            "page_size": 20},
        **{f"text_{agg.lower()}": {"query": leaf("text_embeddings", "st/smoke", 6,
                                                 distance_aggregation=agg), "page_size": 30}
           for agg in ("MIN", "MAX", "AVG")},
        "similar_to": {"query": {"similar_to": {"target": f"{4:08x}" * 8, "model": "st/smoke",
                                                "distance_aggregation": "AVG", "index": "quant"}},
                       "page_size": 20},
        "partition_by": {"query": leaf("image_embeddings", "clip/smoke", 12), "partition_by": ["type"],
                         "page_size": 10},
    }


def same_pages(got, want, atol: float = 1e-6) -> bool:
    """Equal pages: counts, ids and order equal, every field equal but the
    float values of ``extra`` (selected scores), which agree within
    ``atol``."""
    if got.count != want.count or len(got.results) != len(want.results):
        return False
    for g, w in zip(got.results, want.results):
        if {k: v for k, v in g.items() if k != "extra"} != {k: v for k, v in w.items() if k != "extra"}:
            return False
        ge, we = g.get("extra") or {}, w.get("extra") or {}
        if ge.keys() != we.keys():
            return False
        for key, value in ge.items():
            if isinstance(value, float) and isinstance(we[key], float):
                if value != we[key] and not abs(value - we[key]) <= atol:
                    return False
            elif value != we[key]:
                return False
    return True


def db_path(torch, dev, smi) -> dict:
    """Phase 9(c): seed_pql_db's DB through an Executor on the card and one
    on the CPU over the same files: equal pages on every shape."""
    import tempfile

    from panoptikon_tpu_torch.pql import model as pql
    from panoptikon_tpu_torch.pql.executor import Executor

    fts5 = "ENABLE_FTS5" in {row[0] for row in sqlite3.connect(":memory:").execute(
        "PRAGMA compile_options")}
    require(fts5, f"db: SQLite {sqlite3.sqlite_version} has no FTS5, which the schema needs")
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as root:
        t0 = time.perf_counter()
        db, writer, index = seed_pql_db(root, PQL_DB_ITEMS, SEED + 40)
        seed_s = time.perf_counter() - t0
        try:
            card, cpu = Executor(db, index, device=str(dev)), Executor(db, index, device="cpu")
            shapes, times = pql_db_shapes(index), {}
            for name, payload in shapes.items():
                t0 = time.perf_counter()
                got = card.execute(pql.PqlQuery.from_json(json.loads(json.dumps(payload))))
                times[name] = 1e3 * (time.perf_counter() - t0)
                want = cpu.execute(pql.PqlQuery.from_json(json.loads(json.dumps(payload))))
                require(len(got.results) > 0, f"db: {name} returned no rows")
                require(same_pages(got, want), f"db: {name} differs between the card and the CPU")
        finally:
            writer.close()
    return {"card": smi, "items": PQL_DB_ITEMS, "seed_s": seed_s, "shapes": len(shapes),
            "card_equals_cpu": True, "card_ms_first_run": times}


def seeded_texts(n: int, seed: int, words: tuple = TEXT_WORDS) -> list:
    """n texts of distinct seeded words, their word counts log-uniform in
    ``words`` (both ends included): with the hash tokenizer a word is one
    token, so at TEXT_WORDS every length bucket 32-512 occurs, and the
    longest texts chunk five times."""
    rng = np.random.default_rng(seed)
    lo, hi = words
    counts = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), size=n)).astype(int)
    counts[:2] = words
    vocab = np.array([f"w{j}" for j in range(30_000)])
    return [" ".join(vocab[rng.integers(0, len(vocab), size=int(m))]) for m in counts]


def text_manager(user_toml: str | None = None, root=None):
    """The port's model manager over its built-in registry (plus a user
    registry file written under ``root``) and IMPL_INDEX."""
    from panoptikon_tpu_torch.models.impls import IMPL_INDEX
    from panoptikon_tpu_torch.models.manager import ModelManager
    from panoptikon_tpu_torch.models.registry import Registry

    user_dir = None
    if user_toml is not None:
        user_dir = Path(root) / "registry"
        user_dir.mkdir()
        (user_dir / "50_smoke.toml").write_text(user_toml)
    return ModelManager(Registry(None, user_dir), IMPL_INDEX)


def text_embed_path(torch, dev, smi, counters):
    """Phase 10(a): both text models loaded by the real model manager with
    prewarm, TEXT_N seeded texts embedded through manager.predict in windows
    of TEXT_WINDOW. Returns (the record, the manager)."""
    from panoptikon_tpu_torch.models import batching, text_embed
    from panoptikon_tpu_torch.models.impls import PredictionInput, npy
    from panoptikon_tpu_torch.ops import vit_attention

    manager = text_manager()
    texts = seeded_texts(TEXT_N, SEED + 50)
    out = {}
    for model in TEXT_MODELS:
        t0 = time.perf_counter()
        manager.load_model(model, cache_key=TEXT_CACHE_KEY, lru_size=len(TEXT_MODELS), prewarm=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        entry = manager._models[model]
        impl = entry.model
        require(entry.default_batch == TEXT_WINDOW and impl.combine_threshold == 4
                and impl.device.type == dev.type, f"text: {model} as the registry defines it")
        cap, ladder = impl.batch_ladder[-1], impl.length_ladder
        chunks = [text_embed.split_tokens(impl.tokenize(t), impl.max_seq_length) for t in texts]
        window_ms, window_chunks, by_bucket, rows = [], [], {}, []
        for lo in range(0, TEXT_N, TEXT_WINDOW):
            inputs = [PredictionInput(data={"text": t}) for t in texts[lo:lo + TEXT_WINDOW]]
            t0 = time.perf_counter()
            got = manager.predict(model, inputs, cache_key=TEXT_CACHE_KEY, lru_size=len(TEXT_MODELS))
            window_ms.append(1e3 * (time.perf_counter() - t0))
            rows.extend(npy.parse_npy(o) for o in got)
            window = [c for cs in chunks[lo:lo + TEXT_WINDOW] for c in cs]
            window_chunks.append(len(window))
            bucket = batching.bucket_for(max(len(c) for c in window), ladder)
            by_bucket.setdefault(bucket, []).append(window_ms[-1])
        for i, (cs, r) in enumerate(zip(chunks, rows)):
            want = len(cs) + (len(cs) >= impl.combine_threshold)
            require(r.shape == (want, impl.cfg.embed_dim) and r.dtype == np.float32,
                    f"text {model}: text {i} has rows {r.shape}, chunks {len(cs)}")
            require(bool(np.isfinite(r).all()), f"text {model}: text {i} has a non-finite row")
        flat = [c for cs in chunks for c in cs]
        buckets = [batching.bucket_for(len(c), ladder) for c in flat]
        require(set(buckets) == set(ladder), f"text {model}: length buckets {sorted(set(buckets))}")
        require(max(window_chunks) > cap, f"text {model}: no window past the batch cap {cap}")
        # TEXT_CHECKED chunks spread over every length bucket, encoded by B3
        # and with mha_plain in its place.
        per = TEXT_CHECKED // len(ladder)
        picked = []
        for bucket in ladder:
            idx = [j for j, b in enumerate(buckets) if b == bucket]
            picked += [idx[int(x)] for x in np.linspace(0, len(idx) - 1, min(per, len(idx)))]
        sample = [flat[j] for j in picked]
        kernel_mha = vit_attention.mha
        with not_counted(counters):
            got = impl.encode_chunks(sample)
            vit_attention.mha = lambda q, k, v, causal=False, key_mask=None: vit_attention.mha_plain(
                q, k, v, causal=causal, key_mask=key_mask)
            try:
                want = impl.encode_chunks(sample)
            finally:
                vit_attention.mha = kernel_mha
        cos = cosines(got, want)
        require(float(cos.min()) >= 0.999, f"text {model}: B3 vs mha_plain min cosine {cos.min()}")
        # One full slice (cap chunks) of each length bucket, on the device.
        gen = torch.Generator(device=dev).manual_seed(SEED + 51)
        slice_ms = {}
        with not_counted(counters):
            for length in ladder:
                ids = torch.randint(3, impl.cfg.vocab, (cap, length), generator=gen, device=dev,
                                    dtype=torch.int32)
                mask = torch.ones_like(ids)
                slice_ms[length] = cuda_ms(
                    torch, lambda: text_embed.encode(impl.params, impl.cfg, ids, mask), reps=5,
                    warmup=1)
        total_s = sum(window_ms) / 1e3
        out[model] = {
            "width": impl.cfg.width, "layers": impl.cfg.layers, "heads": impl.cfg.heads,
            "head_dim": impl.cfg.width // impl.cfg.heads, "load_and_prewarm_s": load_s,
            "texts": TEXT_N, "chunks": len(flat), "valid_tokens": sum(len(c) for c in flat),
            "combined_rows": sum(len(cs) >= impl.combine_threshold for cs in chunks),
            "chunks_by_length_bucket": {b: buckets.count(b) for b in ladder},
            "windows": len(window_ms), "max_chunks_in_a_window": max(window_chunks),
            "windows_past_the_batch_cap": sum(n > cap for n in window_chunks),
            "chunks_per_s": len(flat) / total_s,
            "valid_tokens_per_s": sum(len(c) for c in flat) / total_s,
            "window_ms_by_longest_bucket": {b: float(np.mean(v)) for b, v in sorted(by_bucket.items())},
            "windows_by_longest_bucket": {b: len(v) for b, v in sorted(by_bucket.items())},
            "checked_chunks": len(sample), "min_cos_b3_vs_plain": float(cos.min()),
            "slice_ms_by_length_bucket": slice_ms,
            "slice_tokens_per_s_by_length_bucket": {n: cap * n / (t / 1e3) for n, t in slice_ms.items()},
        }
    return {"card": smi, "window": TEXT_WINDOW, "models": out}, manager


class TimedManager:
    """The model manager with the host time of each predict recorded (the
    embed part of a PQL query's preprocess)."""

    def __init__(self, manager):
        self.manager, self.registry, self.seconds = manager, manager.registry, []

    def predict(self, *args, **kw):
        t0 = time.perf_counter()
        out = self.manager.predict(*args, **kw)
        self.seconds.append(time.perf_counter() - t0)
        return out


def _bulk_seed(conn, n: int, texts=None, data_offset: int = 0) -> None:
    """tools/e2e_server_bench.py's corpus (_inserts, :62-101) under
    bulk_ingest: n items and files, and n OCR text chunks with live FTS,
    item_data id i + data_offset (on item i) paired with extracted_text id
    i + data_offset; the texts are ``texts`` where given."""
    from panoptikon_tpu_torch.db.bulk import bulk_ingest

    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "ocean", "forest", "mountain",
             "river"]

    def text(i):  # (text, text_length)
        if texts is not None:
            return texts[i - 1], len(texts[i - 1])
        return (f"{words[i % 10]} {words[(i // 10) % 10]} {words[(i // 100) % 10]} "
                f"tok{i % 5000:04d}", 40)

    with bulk_ingest(conn):
        conn.executemany(
            "INSERT INTO items (id, sha256, md5, type, size, time_added) VALUES (?,?,?,?,?,?)",
            ((i, f"{i:08x}" + "0" * 56, f"{i:032x}"[:32], "image/png", 1000 + i % 5000,
              "2026-01-01T00:00:00") for i in range(1, n + 1)))
        conn.executemany(
            "INSERT INTO files (id, sha256, item_id, path, filename, last_modified)"
            " VALUES (?,?,?,?,?,?)",
            ((i, f"{i:08x}" + "0" * 56, i, f"/corpus/{i:07d}.png", f"{i:07d}.png",
              "2026-01-01T00:00:00") for i in range(1, n + 1)))
        sid = conn.execute("INSERT INTO setters (name) VALUES ('ocr/e2e')").lastrowid
        conn.executemany(
            "INSERT INTO item_data (id, item_id, setter_id, data_type, idx, is_origin)"
            " VALUES (?,?,?,?,0,1)",
            ((i + data_offset, i, sid, "text") for i in range(1, n + 1)))
        conn.executemany(
            "INSERT INTO extracted_text (id, text, text_length, language, language_confidence,"
            " confidence) VALUES (?,?,?,?,?,?)",
            ((i + data_offset, *text(i), "en", 0.9, 0.8) for i in range(1, n + 1)))


def hybrid_path(torch, dev, smi, manager, counters) -> dict:
    """Phase 10(b): BASELINE #4 through Executor.execute — an AND of a
    match_text RRF leaf on a "tokNNNN" term and a text_embeddings RRF leaf
    whose query is a text, embedded through the model manager, over
    HYBRID_ROWS text chunks (tools/e2e_server_bench.py's hybrid_payload,
    :265-283) in a HYBRID_ROWS × 768 mpnet-base space whose int8 codes are
    made on the device (as phase 9(a)'s)."""
    import tempfile

    from panoptikon_tpu_torch.db.connection import Database
    from panoptikon_tpu_torch.db.writer import IndexWriter

    with tempfile.TemporaryDirectory(dir=scratch_dir()) as root:
        db = Database(root, "hybrid")
        writer = IndexWriter(db)
        try:
            t0 = time.perf_counter()
            writer.call(lambda conn: _bulk_seed(conn, HYBRID_ROWS))
            out = {"card": smi, "seed_db_s": time.perf_counter() - t0}
            out.update(_hybrid_queries(torch, dev, manager, counters, db))
            return out
        finally:
            writer.close()


def _hybrid_queries(torch, dev, manager, counters, db) -> dict:
    """Phase 10(b) on its seeded DB: the space, then the queries."""
    import itertools
    import threading

    from panoptikon_tpu_torch.pql import model as pql
    from panoptikon_tpu_torch.pql import preprocess
    from panoptikon_tpu_torch.pql.executor import Executor

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    codes, sumsq, scale, recall = _or3_space(torch, dev, HYBRID_ROWS, HYBRID_DIM, SEED + 60, counters)
    require(recall["rescored"] >= 0.99, f"hybrid: recall@10 of the rescored candidates {recall}")
    index = _Index()
    snap = index.snaps[HYBRID_SPACE] = _Snap(HYBRID_ROWS, HYBRID_DIM, scale)
    timed = TimedManager(manager)
    ex = Executor(db, index, manager=timed, device=str(dev))
    ex.device_cache_budget = OR3_CACHE_BUDGET
    key = (HYBRID_SPACE, snap.generation, True)
    with ex._cache_lock:
        ex._device_cache[key] = {
            "corpus": codes, "sumsq": sumsq,
            "group_ids": torch.arange(HYBRID_ROWS, dtype=torch.int32, device=dev),
            "weights": torch.ones(HYBRID_ROWS, dtype=torch.float32, device=dev),
            "row_valid": torch.ones(HYBRID_ROWS, dtype=torch.bool, device=dev)}
        ex._device_cache_bytes[key] = codes.numel()
    torch.cuda.empty_cache()
    space_s = time.perf_counter() - t0

    def fail_materialize(*a, **k):
        raise RuntimeError("the fused hybrid page fell back to the full readback")

    ex._materialize_deferred = fail_materialize
    rng = np.random.default_rng(SEED + 61)
    numbers = itertools.count()
    words = ("a photo of the red blue green small large dog cat car tree house beach night city "
             "street ocean forest mountain river alpha beta gamma delta").split()
    embed = {"cache_key": TEXT_CACHE_KEY, "lru_size": len(TEXT_MODELS)}

    def payload():
        i = next(numbers)
        tok = f"tok{(7 + 13 * (i % 997)) % 5000:04d}"
        text = " ".join(rng.choice(words, size=8)) + f" query {i}"
        return {"query": {"and_": [
            {"match_text": {"match": f'"{tok}"'}, "order_by": True, "row_n": True, "priority": 5,
             "rrf": {"k": 60, "weight": 1.0}},
            {"text_embeddings": {"query": text, "model": HYBRID_SPACE, "embed": embed,
                                 "index": "quant"},
             "row_n": True, "priority": 5, "rrf": {"k": 60, "weight": 0.5}}]}, "page_size": 10}

    def run(p):
        return ex.execute(pql.PqlQuery.from_json(p))

    t0 = time.perf_counter()
    r = run(payload())
    warm_s = time.perf_counter() - t0
    per_term = HYBRID_ROWS // 5000
    require(r.count == per_term and len(r.results) == 10 and r.metrics.path == "fused",
            f"hybrid: count {r.count}, {len(r.results)} results, path {r.metrics.path}")

    parity = [payload() for _ in range(HYBRID_PARITY_Q)]
    fused = [_pages(run(p).results) for p in parity]
    ex._materialize_deferred = type(ex)._materialize_deferred.__get__(ex)
    ex.enable_fused = False
    full = [_pages(run(p).results) for p in parity]
    ex.enable_fused = True
    ex._materialize_deferred = fail_materialize
    require(fused == full, f"hybrid: fused pages differ from the full readback: {fused} vs {full}")

    # Sequential: distinct texts and terms, so that no embed is cached.
    ex.debug_timing = True
    lats, phases, embeds = [], {}, []
    for _ in range(HYBRID_SEQ):
        p = payload()
        n_embeds = len(timed.seconds)
        t0 = time.perf_counter()
        res = run(p)
        lats.append(time.perf_counter() - t0)
        require(len(timed.seconds) == n_embeds + 1, "hybrid: a sequential query's embed was cached")
        embeds.append(timed.seconds[-1])
        require(len(res.results) == 10 and res.metrics.path == "fused", "hybrid: a fused page of 10")
        for name, sec in res.metrics.phases.items():
            phases[name] = phases.get(name, 0.0) + 1e3 * sec / HYBRID_SEQ
    ex.debug_timing = False
    lats.sort()
    seq = [payload() for _ in range(HYBRID_SEQ)]
    prof_wall, busy = busy_share(torch, lambda: [run(p) for p in seq])

    def threaded(batch):
        out, errs = [None] * len(batch), []

        def drive(idx):
            try:
                for i in idx:
                    out[i] = _pages(run(batch[i]).results)
            except Exception as exc:  # noqa: BLE001 - re-raised below
                errs.append(exc)

        ts = [threading.Thread(target=drive, args=(range(t, len(batch), HYBRID_THREADS),))
              for t in range(HYBRID_THREADS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errs:
            raise errs[0]
        return out

    for _ in range(2):
        threaded([payload() for _ in range(HYBRID_THREADS)])
    batch = [payload() for _ in range(HYBRID_CONCURRENT)]
    co0, n_embeds = ex._scan_coalescer.stats(), len(timed.seconds)
    t0 = time.perf_counter()
    concurrent = threaded(batch)
    wall = time.perf_counter() - t0
    co1 = ex._scan_coalescer.stats()
    concurrent_embeds = len(timed.seconds) - n_embeds
    solo = [_pages(run(p).results) for p in batch]  # the embeds now come from EMBED_CACHE
    require(concurrent == solo, "hybrid: a coalesced page differs from its solo run")
    dispatches, queries = co1["dispatches"] - co0["dispatches"], co1["queries"] - co0["queries"]
    return {
        "rows": HYBRID_ROWS, "dim": HYBRID_DIM, "space": HYBRID_SPACE,
        "chunks_per_term": per_term, "space_build_s": space_s,
        "codes_gib": HYBRID_ROWS * HYBRID_DIM / 2**30, "recall_at_10_and_b1": recall,
        "warm_s": warm_s, "parity_queries": HYBRID_PARITY_Q, "fused_equals_full": True,
        "p50_ms": 1e3 * lats[len(lats) // 2],
        "p95_ms": 1e3 * lats[min(len(lats) - 1, int(len(lats) * 0.95))],
        "sequential_ms": [1e3 * t for t in lats],
        "embed_ms_p50": 1e3 * sorted(embeds)[len(embeds) // 2],
        "executor_phase_ms": phases, "fts_and_masks_ms": phases.get("eval", 0.0),
        "preprocess_ms_without_embed": phases.get("preprocess", 0.0) - 1e3 * float(np.mean(embeds)),
        "profiled_sequential_s": prof_wall, "device_busy_share": busy, "device_idle_share": 1 - busy,
        "concurrent_qps": HYBRID_CONCURRENT / wall, "concurrent_wall_s": wall,
        "concurrent_embed_calls": concurrent_embeds, "coalesced_equals_solo": True,
        "coalescer": {"dispatches": dispatches, "queries": queries, "max_batch": co1["max_batch"],
                      "mean_batch": queries / dispatches if dispatches else 0.0},
        "embed_cache": preprocess.EMBED_CACHE.stats(),
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
    }


def text_db_shapes(index, texts) -> dict:
    """Phase 10(c)'s PQL shapes over seed_pql_db's DB with real text
    embeddings: the text leaves' queries are texts, embedded through the
    model manager."""
    mini, mpnet = TEXT_MODELS
    embed = {"cache_key": TEXT_CACHE_KEY, "lru_size": len(TEXT_MODELS)}

    def tleaf(model, text, **extra):
        return {"text_embeddings": {"query": text, "model": model, "embed": embed, "index": "quant",
                                    **extra}}

    rrf = {"row_n": True, "priority": 5}
    clip = {"image_embeddings": {"query": _b64(index.snapshot("clip/smoke").vectors[11] + 0.01),
                                 "model": "clip/smoke", "embed": None, "index": "quant"}}
    return {
        "semantic_mpnet": {"query": tleaf(mpnet, texts[0]), "page_size": 20},
        "semantic_minilm_exact": {"query": tleaf(mini, texts[1], index="exact"), "page_size": 20},
        **{f"text_{agg.lower()}": {"query": tleaf(mini, texts[2], distance_aggregation=agg),
                                   "page_size": 30} for agg in ("MIN", "MAX", "AVG")},
        "and_rrf": {"query": {"and_": [{**tleaf(mini, texts[3]), **rrf, "rrf": {"k": 60, "weight": 1.0}},
                                       {**tleaf(mpnet, texts[3]), **rrf, "rrf": {"k": 30, "weight": 0.5}}]},
                    "page_size": 20},
        "or_rrf": {"query": {"or_": [{**clip, **rrf, "rrf": {"k": 60, "weight": 1.0}},
                                     {**tleaf(mini, texts[4]), **rrf, "rrf": {"k": 60, "weight": 0.8}}]},
                   "page_size": 20},
        "hybrid": {"query": {"and_": [
            {"match_text": {"match": '"gamma"'}, "order_by": True, **rrf, "rrf": {"k": 60, "weight": 1.0}},
            {**tleaf(mpnet, texts[5]), **rrf, "rrf": {"k": 60, "weight": 0.5}}]}, "page_size": 20},
        "similar_to": {"query": {"similar_to": {"target": f"{4:08x}" * 8, "model": mini,
                                                "distance_aggregation": "AVG", "index": "quant"}},
                       "page_size": 20},
    }


def _embedded(obj):
    """A payload with each text leaf's query replaced by the vector the
    card embedded for it (preprocess.EMBED_CACHE), as base64, embed None."""
    from panoptikon_tpu_torch.pql import preprocess

    if isinstance(obj, list):
        return [_embedded(v) for v in obj]
    if not isinstance(obj, dict):
        return obj
    out = {k: _embedded(v) for k, v in obj.items()}
    leaf = out.get("text_embeddings")
    if isinstance(leaf, dict) and leaf.get("embed") is not None:
        vec = preprocess.EMBED_CACHE.get((leaf["model"], "text", leaf["query"]))
        require(vec is not None, f"text db: {leaf['query']!r} was not embedded on the card")
        out["text_embeddings"] = {**leaf, "query": _b64(vec), "embed": None}
    return out


def text_db_path(torch, dev, smi, manager) -> dict:
    """Phase 10(c): seed_pql_db's DB with its two text spaces filled by the
    manager's minilm-l6 and mpnet-base embeddings of its own texts; PQL
    shapes whose text leaves are embedded once on the card, then the same
    vectors handed to an Executor on the card and one on the CPU."""
    import tempfile

    from panoptikon_tpu_torch.pql import model as pql
    from panoptikon_tpu_torch.pql.executor import Executor

    with tempfile.TemporaryDirectory(dir=scratch_dir()) as root:
        t0 = time.perf_counter()
        db, writer, index = seed_pql_db(root, TEXT_DB_ITEMS, SEED + 70, manager=manager)
        seed_s = time.perf_counter() - t0
        try:
            rows = {m: index.snapshot(m).size for m in TEXT_MODELS}
            texts = [r[0] for r in db.reader().execute(
                "SELECT text FROM extracted_text ORDER BY id LIMIT 6").fetchall()]
            card = Executor(db, index, manager=manager, device=str(dev))
            cpu = Executor(db, index, device="cpu")
            checked = {}
            for name, payload in text_db_shapes(index, texts).items():
                by_text = card.execute(pql.PqlQuery.from_json(json.loads(json.dumps(payload))))
                given = _embedded(payload)
                got = card.execute(pql.PqlQuery.from_json(json.loads(json.dumps(given))))
                want = cpu.execute(pql.PqlQuery.from_json(json.loads(json.dumps(given))))
                require(len(got.results) > 0, f"text db: {name} returned no rows")
                require(same_pages(by_text, got), f"text db: {name} by text differs from by vector")
                require(same_pages(got, want), f"text db: {name} differs between the card and the CPU")
                checked[name] = len(got.results)
        finally:
            writer.close()
    return {"card": smi, "items": TEXT_DB_ITEMS, "seed_s_with_embeds": seed_s, "text_rows": rows,
            "shapes": checked, "card_equals_cpu": True}


def extraction_runners(manager, db, writer, index) -> dict:
    """The server's DATA_EXTRACTION and VECTOR_QUANT_RECONCILE runners
    (api/server.py's _extraction_body, :362-386, and _run_reconcile,
    :388-396): the job's arguments from the handle's params and the
    registry's group metadata."""
    from panoptikon_tpu_torch.jobs import extraction, reconcile
    from panoptikon_tpu_torch.jobs.queue import JobType

    def run_extraction(handle):
        params = handle.params
        inference_id = params["inference_id"]
        meta = manager.registry.group_metadata(inference_id.split("/", 1)[0])
        t0 = time.perf_counter()
        report = extraction.run_extraction_job(
            db=db, writer=writer, index=index, manager=manager, inference_id=inference_id,
            setter_name=params.get("setter_name"),
            output_type=params.get("output_type") or meta.get("output_type", "clip"),
            mime_prefixes=tuple(params.get("mime_types") or meta.get("input_mime_types", ["image/"])),
            batch_size=int(params.get("batch_size") or meta.get("default_batch_size", 16)),
            threshold=params.get("threshold") or meta.get("default_threshold"),
            target_entity="text" if "text" in (meta.get("target_entities") or ["items"]) else "items",
            source_setters=tuple(params.get("source_setters") or ()),
            input_handler=(meta.get("input_spec") or {}).get("handler"),
            input_handler_opts=(meta.get("input_spec") or {}).get("opts"),
            cancelled=lambda: handle.cancelled)
        handle.result = {"report": report, "wall_s": time.perf_counter() - t0}
        return report.summary

    def run_reconcile(handle):
        t0 = time.perf_counter()
        report = reconcile.run_reconcile(db, writer, index, cancelled=lambda: handle.cancelled,
                                         force_rescale=bool(handle.params.get("force_rescale")))
        handle.result = {**report.__dict__, "wall_s": time.perf_counter() - t0}

    return {JobType.DATA_EXTRACTION: run_extraction, JobType.VECTOR_QUANT_RECONCILE: run_reconcile}


def run_jobs(runners, db_name: str, jobs: list, timeout: float = 900.0) -> list:
    """Enqueue ``jobs`` ((JobType, params) pairs) on a JobQueue, wait until
    it is idle, and return their handles; every job must complete."""
    from panoptikon_tpu_torch.jobs.queue import JobQueue

    queue = JobQueue(runners)
    try:
        handles = [queue.enqueue(db_name, job_type, params) for job_type, params in jobs]
        require(queue.wait_idle(db_name, timeout=timeout), f"jobs on {db_name}: not idle in time")
    finally:
        queue.shutdown()
    for h in handles:
        require(h.state == "completed", f"job {h.job_type.value}: {h.state} {h.error}")
    return handles


@contextlib.contextmanager
def encode_events(torch, text_embed):
    """CUDA events around every text_embed.encode call while inside: the
    device span of each forward (an upper bound of its busy time: gaps
    between its kernels count as busy). Yields the list of event pairs."""
    pairs, encode = [], text_embed.encode

    def timed(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = encode(*args, **kw)
        end.record()
        pairs.append((start, end))
        return out

    text_embed.encode = timed
    try:
        yield pairs
    finally:
        text_embed.encode = encode


def chunk_lengths(texts, max_len: int) -> list:
    """The chunks each text becomes under the hash tokenizer (BOS, a token a
    word, EOS), by length: text_embed.split_tokens depends only on it."""
    from panoptikon_tpu_torch.models import text_embed

    return [[len(c) for c in text_embed.split_tokens([0] * (len(t.split()) + 2), max_len)]
            for t in texts]


def extract_path(torch, dev, smi, counters) -> list:
    """Phase 11: (a) the build of N_BUILD OCR rows through the JobQueue,
    (b) the hard checks on what was built, (c) the built space searched
    through Executor.execute. Returns the three records."""
    import tempfile

    from panoptikon_tpu_torch.db.connection import Database
    from panoptikon_tpu_torch.db.writer import IndexWriter
    from panoptikon_tpu_torch.index import VectorIndex

    with tempfile.TemporaryDirectory(dir=scratch_dir()) as root:
        db = Database(root, "build")
        writer = IndexWriter(db)
        manager = text_manager()
        try:
            index = VectorIndex()
            texts = seeded_texts(N_BUILD, SEED + 80, BUILD_WORDS)
            built = _extract_build(torch, dev, smi, counters, db, writer, index, manager, texts)
            checks = _extract_checks(db, writer, index, built.pop("report"), built["embed_dim"])
            search = _extract_search(torch, dev, smi, counters, db, index, manager, texts)
        finally:
            manager.shutdown()
            writer.close()
    return [built, checks, search]


def _extract_build(torch, dev, smi, counters, db, writer, index, manager, texts) -> dict:
    """Phase 11(a): seed, load BUILD_MODEL with prewarm, then the
    DATA_EXTRACTION and VECTOR_QUANT_RECONCILE jobs, timed by part."""
    from panoptikon_tpu_torch.jobs import reconcile
    from panoptikon_tpu_torch.jobs.queue import JobType
    from panoptikon_tpu_torch.models import text_embed
    from panoptikon_tpu_torch.models.impls import PredictionInput
    from panoptikon_tpu_torch.ops import codec

    t0 = time.perf_counter()
    writer.call(lambda conn: _bulk_seed(conn, N_BUILD, texts, BUILD_DATA_OFFSET))
    seed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    manager.load_model(BUILD_MODEL, cache_key=BUILD_CACHE_KEY, lru_size=1, prewarm=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    entry = manager._models[BUILD_MODEL]
    impl = entry.model
    require(entry.default_batch == TEXT_WINDOW and impl.combine_threshold == 4
            and impl.device.type == dev.type and impl.cfg == text_embed.CONFIGS["mpnet-base"]
            and impl.max_seq_length == 512, f"extract: {BUILD_MODEL} as the registry defines it")
    chunks = chunk_lengths(texts, impl.max_seq_length)
    multi = [len(c) > 1 for c in chunks]
    windows = [any(multi[lo:lo + TEXT_WINDOW]) for lo in range(0, N_BUILD, TEXT_WINDOW)]
    require(sum(windows) * 2 > len(windows), f"extract: {sum(windows)} of {len(windows)} windows "
                                             "hold a text that chunks")
    n_chunks = sum(len(c) for c in chunks)
    valid_tokens = sum(sum(c) for c in chunks)
    combined = sum(len(c) >= impl.combine_threshold for c in chunks)

    # The device's idle share over one whole manager window (the profiler),
    # off the main path's counts.
    window = [PredictionInput(data={"text": t}) for t in texts[:TEXT_WINDOW]]
    with not_counted(counters):
        manager.predict(BUILD_MODEL, window, max_batch=TEXT_WINDOW)
        window_wall, window_busy = busy_share(
            torch, lambda: manager.predict(BUILD_MODEL, window, max_batch=TEXT_WINDOW))

    quant_t = [0.0]
    reconcile_space = reconcile.reconcile_space

    def timed_reconcile(*a, **k):
        q0 = time.perf_counter()
        try:
            return reconcile_space(*a, **k)
        finally:
            quant_t[0] += time.perf_counter() - q0

    runners = extraction_runners(manager, db, writer, index)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls0 = dict(codec.native_calls)
    reconcile.reconcile_space = timed_reconcile
    try:
        with encode_events(torch, text_embed) as spans:
            job, rec = run_jobs(runners, "build", [
                (JobType.DATA_EXTRACTION, {"inference_id": BUILD_MODEL}),
                (JobType.VECTOR_QUANT_RECONCILE, {})])
            torch.cuda.synchronize()
    finally:
        reconcile.reconcile_space = reconcile_space
    native_calls = {k: codec.native_calls[k] - calls0[k] for k in calls0}
    require(codec.native_available() and native_calls["quantize"] > 0,
            f"extract: the reconcile did not quantize through the native codec {native_calls}")
    report, wall = job.result["report"], job.result["wall_s"]
    encode_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    again = run_jobs(runners, "build", [(JobType.DATA_EXTRACTION, {"inference_id": BUILD_MODEL})])
    require(again[0].result["report"].processed == 0, "extract: a second job found work")
    launches = {fn.__name__: fn.launches for fn in counters}
    texts_per_s = report.processed / wall
    return {
        "part": "a_build", "card": smi, "model": BUILD_MODEL, "width": impl.cfg.width,
        "embed_dim": impl.cfg.embed_dim,
        "layers": impl.cfg.layers, "heads": impl.cfg.heads, "rows": N_BUILD,
        "words": BUILD_WORDS, "chunks": n_chunks, "valid_tokens": valid_tokens,
        "multi_chunk_texts": sum(multi), "combined_rows": combined,
        "windows_with_a_text_that_chunks": sum(windows), "windows": len(windows),
        "seed_db_s": seed_s, "load_and_prewarm_s": load_s, "job_wall_s": wall,
        "processed": report.processed, "segments": report.segments,
        "texts_per_s": texts_per_s, "chunks_per_s": n_chunks / wall,
        "valid_tokens_per_s": valid_tokens / wall,
        "load_stall_s": report.data_load_time, "inference_s": report.inference_time,
        "quant_reconcile_s": quant_t[0],
        "db_index_writes_s": wall - report.data_load_time - report.inference_time - quant_t[0],
        "reconcile_job_s": rec.result["wall_s"],
        "projected_s_for_1m_text_rows": 1e6 / texts_per_s,
        "encode_calls": len(spans), "encode_device_span_s": encode_s,
        "device_busy_share_job_upper_bound": encode_s / wall,
        "device_idle_share_job_lower_bound": 1 - encode_s / wall,
        "window_wall_s": window_wall, "device_idle_share_window": 1 - window_busy,
        "b3_launches_by_route": read_routes(counters).get("mha", {}),
        "launches": launches, "host_codec_native_calls": native_calls,
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
        "report": report,
    }


def _extract_checks(db, writer, index, report, dim: int, space: str = BUILD_MODEL,
                    n_items: int = N_BUILD, weight: float = 0.8 * 0.9,
                    data_offset: int | None = BUILD_DATA_OFFSET) -> dict:
    """Phase 11(b) (and 12(b) over the CLAP space): the job's report, the
    coverage row, the codes against the host codec of the vectors stored in
    SQLite, weights, ownership (with ``data_offset``, each row sourced from
    its item's text row that many ids apart), and a fresh index synced from
    the DB equal to the built one."""
    from panoptikon_tpu_torch.db import store
    from panoptikon_tpu_torch.index import VectorIndex
    from panoptikon_tpu_torch.jobs import index_sync, reconcile
    from panoptikon_tpu_torch.ops import codec

    require(report.processed == n_items and report.input_errors == 0
            and report.transient_errors == 0,
            f"extract: processed {report.processed}, errors {report.input_errors} input, "
            f"{report.transient_errors} transient")
    conn = db.reader()
    rows = conn.execute("SELECT COUNT(*) FROM embeddings e JOIN item_data d ON d.id = e.id"
                        " JOIN setters s ON s.id = d.setter_id WHERE s.name = ?",
                        (space,)).fetchone()[0]
    status = reconcile.coverage_status(db)
    require(status == [{"profile": "int8", "setter": space, "state": "ready",
                        "artifact_rev": 1, "n_at_artifact": rows, "dim": dim}],
            f"extract: coverage {status}, {rows} rows")
    snap = index.snapshot(space)
    n = snap.size
    require(snap.quant_ready and n == rows == report.segments, f"extract: snapshot of {n} rows")
    artifact = conn.execute("SELECT artifact FROM vector_quant_coverage").fetchone()[0]
    scale = codec.artifact_scale(artifact)
    data_ids, item_ids, vectors, weights = store.load_embedding_space(conn, space, limit=rows + 1)
    require(np.array_equal(data_ids, snap.row_ids[:n]) and np.array_equal(vectors, snap.vectors[:n]),
            "extract: the index rows are not the stored rows in row-id order")
    require(scale == snap.scale == codec.scale_from_absmax(codec.corpus_absmax(vectors)),
            f"extract: scale {snap.scale}, artifact {scale}")
    require(np.array_equal(codec.quantize_int8_host(vectors, scale), snap.codes[:n]),
            "extract: codes differ from the host codec of the stored vectors")
    want_w = np.float32(weight)
    require(bool((snap.weights[:n] == want_w).all() and (weights == want_w).all()),
            f"extract: a row's weight is not {weight}")
    strays = 0
    if data_offset is not None:
        strays = conn.execute(
            """SELECT COUNT(*) FROM item_data e JOIN setters s ON s.id = e.setter_id
               JOIN item_data t ON t.id = e.source_id
               WHERE s.name = ? AND (e.item_id != t.item_id OR t.id != t.item_id + ?)""",
            (space, data_offset)).fetchone()[0]
    owners = conn.execute(
        "SELECT COUNT(DISTINCT d.item_id) FROM item_data d JOIN setters s ON s.id = d.setter_id"
        " WHERE s.name = ?", (space,)).fetchone()[0]
    require(strays == 0 and owners == n_items, f"extract: {strays} rows not owned by their item")
    built_items = index.item_id_of_groups(space, snap.group_ids[:n])
    require(np.array_equal(built_items, item_ids), "extract: index item ids differ from the DB's")
    # The server's startup path: a fresh index from SQLite, its quant arm
    # under the frozen artifact.
    t0 = time.perf_counter()
    fresh = VectorIndex()
    added = index_sync.sync_all(db, fresh)
    sync_s = time.perf_counter() - t0
    reconcile.run_reconcile(db, writer, fresh)
    fsnap = fresh.snapshot(space)
    require(added == {space: n} and fsnap.size == n and fsnap.scale == scale
            and np.array_equal(fsnap.row_ids[:n], snap.row_ids[:n])
            and np.array_equal(fresh.item_id_of_groups(space, fsnap.group_ids[:n]), built_items)
            and np.array_equal(fsnap.weights[:n], snap.weights[:n])
            and np.array_equal(fsnap.codes[:n], snap.codes[:n]),
            "extract: the index synced from the DB differs from the built one")
    require(reconcile.coverage_status(db) == status, "extract: the startup reconcile moved coverage")
    return {"part": "b_checks", "rows": n, "items": owners, "scale": scale,
            "coverage": status[0], "codes_equal_host_codec_of_stored_vectors": True,
            "weights": float(want_w), "owned_by_item": True, "sync_all_equals_built": True,
            "sync_all_s": sync_s}


def _extract_search(torch, dev, smi, counters, db, index, manager, texts) -> dict:
    """Phase 11(c): BUILD_QUERIES stored single-chunk texts as
    text_embeddings queries through Executor.execute, one at a time; their
    query vectors' exact f32 top-10 over the stored rows and items against
    the page, the serving path's rescored candidates and B1's plain
    version."""
    from panoptikon_tpu_torch.ops import codec, exact, int8_scan, scoring
    from panoptikon_tpu_torch.pql import model as pql
    from panoptikon_tpu_torch.pql import preprocess
    from panoptikon_tpu_torch.pql.executor import Executor

    snap = index.snapshot(BUILD_MODEL)
    n = snap.size
    words = [len(t.split()) for t in texts]
    single = [i for i, w in enumerate(words) if w + 2 <= 512]
    picks = [single[int(j)] for j in np.linspace(0, len(single) - 1, BUILD_QUERIES)]
    ex = Executor(db, index, manager=manager, device=str(dev))
    embed = {"cache_key": BUILD_CACHE_KEY, "lru_size": 1}

    def payload(text):
        return {"query": {"text_embeddings": {"query": text, "model": BUILD_MODEL, "embed": embed,
                                              "index": "quant"}}, "page_size": K}

    pages, first_ms, again_ms = [], [], []
    for i in picks:
        t0 = time.perf_counter()
        res = ex.execute(pql.PqlQuery.from_json(payload(texts[i])))
        first_ms.append(1e3 * (time.perf_counter() - t0))
        require(len(res.results) == K, f"extract search: {len(res.results)} results")
        pages.append(_pages(res.results))
    for i in picks:  # the query vectors now come from EMBED_CACHE
        t0 = time.perf_counter()
        res = ex.execute(pql.PqlQuery.from_json(payload(texts[i])))
        again_ms.append(1e3 * (time.perf_counter() - t0))
        require(_pages(res.results) == pages[len(again_ms) - 1], "extract search: a page changed")
    q = np.stack([preprocess.EMBED_CACHE.get((BUILD_MODEL, "text", texts[i])) for i in picks])
    x = torch.from_numpy(snap.vectors[:n]).to(dev)
    qt = torch.from_numpy(q).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    dist = exact.pairwise_distance(x, qt)
    _, want_rows, _ = exact.topk_ascending(dist, valid, K)
    # Items: each item's nearest row (the executor's MIN aggregation).
    groups = torch.from_numpy(snap.group_ids[:n].astype(np.int64)).to(dev)
    per_item = torch.full((len(picks), snap.num_groups), float("inf"), device=dev)
    per_item.scatter_reduce_(1, groups.expand(len(picks), -1), dist, "amin")
    _, want_slots = torch.topk(per_item, K, largest=False)
    want_items = index.item_id_of_groups(BUILD_MODEL, want_slots.cpu().numpy())
    page_recall = float(np.mean([len(set(p) & set(w)) / K for p, w in zip(pages, want_items)]))
    own = [i + 1 in p for i, p in zip(picks, pages)]  # item i + 1 holds text i
    require(all(own), f"extract search: a query's own item missing from its page {own}")
    # The serving path's candidates (B1 at k·oversample 40), rescored in f32.
    codes = torch.from_numpy(snap.codes[:n]).to(dev)
    sumsq = scoring.row_sumsq(codes)
    qc = codec.quantize_int8(qt, snap.scale)
    _, got_rows, _ = scoring.int8_topk_rescored(codes, sumsq, valid, x, qc, qt, k=K, oversample=4,
                                                distance="cosine", scale=snap.scale, rescore=True)
    want_rows, got_rows = want_rows.cpu().numpy(), got_rows.cpu().numpy()
    rescored = float(np.mean([len(set(g) & set(w)) / K for g, w in zip(got_rows, want_rows)]))
    require(rescored >= 0.99, f"extract search: rescored recall@10 {rescored} < 0.99")
    with not_counted(counters):
        args = (codes, sumsq, valid, qc)
        gv, gi, gok = int8_scan.int8_topk(*args, k=4 * K)
        pv, pi, pok = int8_scan.int8_topk_plain(*args, k=4 * K)
        torch.cuda.synchronize()
        require(torch.equal(gi, pi) and torch.equal(gok, pok), "extract search: B1 ids differ from plain")
        b1_err = (gv - pv).abs().max().item()
        require(b1_err <= 1e-6, f"extract search: B1 max abs dist diff {b1_err}")
        b1 = dict(zip(("b1_k40_ms", "b1_k40_plain_ms"), paired_ms(
            torch, lambda: int8_scan.int8_topk(*args, k=4 * K),
            lambda: int8_scan.int8_topk_plain(*args, k=4 * K), reps=10)))
        b1.update({"b1_k40_" + key: value for key, value in scan_roofline(args, 4 * K).items()})
        b1["b1_k40_gemm_only_ms"] = gemm_only_ms(torch, args)
    first_ms.sort()
    again_ms.sort()
    return {"part": "c_search", "card": smi, "queries": BUILD_QUERIES, "rows": n,
            "items": snap.num_groups, "rescored_recall_at_10": rescored,
            "executor_page_recall_at_10_items": page_recall, "own_item_in_page": True,
            "b1_k40_max_abs_err": b1_err, **b1,
            "page_p50_ms_with_embed": first_ms[len(first_ms) // 2],
            "page_p50_ms_embed_cached": again_ms[len(again_ms) // 2],
            "page_ms_with_embed": first_ms}


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def extract_pair_path(torch, dev, smi) -> dict:
    """Phase 11(d): BUILD_PAIR_ROWS seeded rows built by the job on the card
    and, in a second DB, on the CPU (the registry's config.device = "cpu",
    the card impl's weights copied over: random weights drawn from a CUDA
    generator and from a CPU one differ). item_data, setters, the ledger
    and coverage (but the artifact) equal; embeddings at cosine ≥ 0.999 row
    by row; codes at most one apart; each scale its own absmax / 127, the
    two within a bf16 rounding."""
    import tempfile

    from panoptikon_tpu_torch.db.connection import Database
    from panoptikon_tpu_torch.db.writer import IndexWriter
    from panoptikon_tpu_torch.index import VectorIndex
    from panoptikon_tpu_torch.jobs.queue import JobType
    from panoptikon_tpu_torch.ops import codec

    texts = seeded_texts(BUILD_PAIR_ROWS, SEED + 81, BUILD_PAIR_WORDS)
    texts[1] = seeded_texts(2, SEED + 82, (BUILD_PAIR_LONG, BUILD_PAIR_LONG))[0]
    cpu_toml = ('allow_override = true\n[group.textembed]\nconfig.device = "cpu"\n'
                '[group.textembed.inference_ids.mpnet-base]\nconfig.model_arch = "mpnet-base"\n')
    out, built = {"part": "d_card_equals_cpu", "card": smi, "rows": BUILD_PAIR_ROWS}, {}
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as root:
        card = text_manager()
        cpu = text_manager(cpu_toml, root)
        try:
            card.load_model(BUILD_MODEL, cache_key=BUILD_CACHE_KEY, lru_size=1, prewarm=True)
            cpu.load_model(BUILD_MODEL, cache_key=BUILD_CACHE_KEY, lru_size=1)
            cpu_impl, card_impl = cpu._models[BUILD_MODEL].model, card._models[BUILD_MODEL].model
            require(cpu_impl.device.type == "cpu" and card_impl.device.type == dev.type,
                    "extract pair: the registries' devices")
            cpu_impl.params = _tree_to(card_impl.params, "cpu")
            for name, manager in (("card", card), ("cpu", cpu)):
                db = Database(Path(root) / name, "pair")
                writer = IndexWriter(db)
                index = VectorIndex()
                try:
                    writer.call(lambda conn: _bulk_seed(conn, BUILD_PAIR_ROWS, texts, 7))
                    jobs = [(JobType.DATA_EXTRACTION, {"inference_id": BUILD_MODEL})]
                    runners = extraction_runners(manager, db, writer, index)
                    if name == "card":  # the device's idle share over a whole job
                        wall, busy = busy_share(torch, lambda: run_jobs(runners, "pair", jobs))
                        out.update({"card_job_wall_s": wall, "device_idle_share_job": 1 - busy})
                    else:
                        t0 = time.perf_counter()
                        run_jobs(runners, "pair", jobs)
                        out["cpu_job_wall_s"] = time.perf_counter() - t0
                    conn = db.reader()
                    built[name] = (
                        {t: conn.execute(f"SELECT * FROM {t} ORDER BY 1, 2").fetchall()
                         for t in ("item_data", "setters", "extraction_errors",
                                   "vector_quant_coverage")},
                        index.snapshot(BUILD_MODEL))
                finally:
                    writer.close()
        finally:
            card.shutdown()
            cpu.shutdown()
    (card_t, card_s), (cpu_t, cpu_s) = built["card"], built["cpu"]
    require(all(card_t[t] == cpu_t[t] for t in card_t if t != "vector_quant_coverage"),
            "extract pair: item_data, setters or the ledger differ between the card and the CPU")
    n = card_s.size
    cos = cosines(card_s.vectors[:n], cpu_s.vectors[:n])
    diff = np.abs(card_s.codes[:n].astype(np.int32) - cpu_s.codes[:n].astype(np.int32))
    ulps = abs(int(np.float32(card_s.scale).view(np.int32)) - int(np.float32(cpu_s.scale).view(np.int32)))
    require(n == cpu_s.size and np.array_equal(card_s.row_ids[:n], cpu_s.row_ids[:n]),
            "extract pair: row ids differ")
    require(float(cos.min()) >= 0.999, f"extract pair: min cosine card vs CPU {cos.min()}")
    require(int(diff.max()) <= 1, f"extract pair: codes {int(diff.max())} apart")
    # Each side's scale is its own absmax / 127, exactly; the two absmaxes
    # are one embedding component computed on two devices through bf16
    # linears, as far apart as any component (0.08-0.21 % between an H100
    # and its host's CPU).
    for snap in (card_s, cpu_s):
        require(snap.scale == codec.scale_from_absmax(codec.corpus_absmax(snap.vectors[:n])),
                "extract pair: a scale is not its corpus absmax / 127")
    rel = abs(card_s.scale - cpu_s.scale) / cpu_s.scale
    require(rel <= 2.0 ** -6, f"extract pair: scales {card_s.scale} and {cpu_s.scale} differ by {rel}")
    # Coverage rows equal but for the artifact (column 3), each its scale.
    require([r[:3] + r[4:] for r in card_t["vector_quant_coverage"]]
            == [r[:3] + r[4:] for r in cpu_t["vector_quant_coverage"]],
            "extract pair: coverage rows differ beyond the artifact")
    require(n > BUILD_PAIR_ROWS, f"extract pair: {n} rows for {BUILD_PAIR_ROWS} texts: none chunked")
    out.update({"chunk_rows": n, "min_cosine_card_vs_cpu": float(cos.min()),
                "max_code_diff": int(diff.max()), "codes_differing": int((diff > 0).sum()),
                "scales": [card_s.scale, cpu_s.scale], "scale_ulps_apart": ulps,
                "scale_rel_diff": rel, "tables_equal": True})
    return out


def write_audio_folder(root: Path, n: int, seed: int) -> list:
    """n seeded WAV files under ``root``: tones, linear chirps and noise
    bursts by turn, seconds log-uniform in AUDIO_SECONDS, 16 kHz mono int16
    but for one in AUDIO_STEREO_EVERY at 44.1 kHz stereo (decode_wav's
    downmix and resample). Returns [(path, seconds, stereo)]."""
    import wave

    rng = np.random.default_rng(seed)
    lo, hi = AUDIO_SECONDS
    out = []
    for i, seconds in enumerate(np.exp(rng.uniform(np.log(lo), np.log(hi), size=n))):
        stereo = i % AUDIO_STEREO_EVERY == AUDIO_STEREO_EVERY - 1
        rate = 44_100 if stereo else 16_000
        t = np.arange(int(seconds * rate), dtype=np.float64) / rate
        if i % 3 == 0:
            sig = 0.5 * np.sin(2 * np.pi * rng.uniform(80, 4000) * t)
        elif i % 3 == 1:
            f0, f1 = rng.uniform(80, 6000, size=2)
            sig = 0.4 * np.sin(2 * np.pi * (f0 + (f1 - f0) * t / (2 * seconds)) * t)
        else:
            gate = np.floor(t * rng.uniform(0.5, 4.0)) % 2 == 0
            sig = 0.3 * rng.standard_normal(t.size) * gate
        pcm = (np.clip(sig, -1.0, 1.0) * 32767).astype("<i2")
        if stereo:
            pcm = np.stack([pcm, pcm // 2], axis=1).reshape(-1)
        path = root / f"clip{i:04d}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(2 if stereo else 1)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(pcm.tobytes())
        out.append((path, t.size / rate, stereo))
    return out


def audio_path(torch, dev, smi, counters) -> list:
    """Phase 12: (a) AUDIO_FILES seeded WAV files scanned, then the whisper
    and clap DATA_EXTRACTION jobs and the quant reconcile on the JobQueue,
    (b) the hard checks on what was built, (c) the transcripts and the CLAP
    space searched through Executor.execute, (d) the split of one whisper
    window. Returns the four records."""
    import tempfile

    from panoptikon_tpu_torch.db import store
    from panoptikon_tpu_torch.db.connection import Database
    from panoptikon_tpu_torch.db.writer import IndexWriter
    from panoptikon_tpu_torch.index import VectorIndex
    from panoptikon_tpu_torch.jobs import scan

    with tempfile.TemporaryDirectory(dir=scratch_dir()) as root:
        folder = Path(root) / "audio"
        folder.mkdir()
        t0 = time.perf_counter()
        clips = write_audio_folder(folder, AUDIO_FILES, SEED + 120)
        write_s = time.perf_counter() - t0
        db = Database(Path(root) / "db", "audio")
        writer = IndexWriter(db)
        manager = text_manager()
        try:
            index = VectorIndex()
            writer.call(lambda conn: store.add_folder(conn, str(folder)))
            t0 = time.perf_counter()
            scanned = scan.rescan_folders(db, writer)
            scan_s = time.perf_counter() - t0
            require(scanned.new_files == AUDIO_FILES, f"audio: scanned {scanned.new_files} files")
            built = _audio_build(torch, dev, smi, counters, db, writer, index, manager, clips)
            built.update({"write_wav_s": write_s, "scan_s": scan_s})
            checks = _audio_checks(db, writer, index, built.pop("reports"), built["clap_dim"])
            search = _audio_search(torch, dev, smi, counters, db, index, manager)
            window = _whisper_window(torch, smi, counters, manager, clips)
        finally:
            manager.shutdown()
            writer.close()
    return [built, checks, search, window]


def _audio_build(torch, dev, smi, counters, db, writer, index, manager, clips) -> dict:
    """Phase 12(a): both models loaded through the manager with prewarm,
    then the whisper and clap jobs and the reconcile, each job's rates and
    split."""
    from panoptikon_tpu_torch.jobs import reconcile
    from panoptikon_tpu_torch.jobs.queue import JobType
    from panoptikon_tpu_torch.models import audio, whisper

    t0 = time.perf_counter()
    for model in (WHISPER_MODEL, CLAP_MODEL):
        manager.load_model(model, cache_key=AUDIO_CACHE_KEY, lru_size=2, prewarm=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    stt, emb = manager._models[WHISPER_MODEL], manager._models[CLAP_MODEL]
    require(stt.default_batch == 4 and stt.model.max_tokens == 64
            and stt.model.cfg == whisper.CONFIGS["whisper-base"] and stt.model.device.type == dev.type,
            f"audio: {WHISPER_MODEL} as the registry defines it")
    require(emb.default_batch == 8 and emb.model.cfg == audio.CONFIGS["clap-base"]
            and emb.model.device.type == dev.type, f"audio: {CLAP_MODEL} as the registry defines it")
    quant_t = [0.0]
    reconcile_space = reconcile.reconcile_space

    def timed_reconcile(*a, **k):
        q0 = time.perf_counter()
        try:
            return reconcile_space(*a, **k)
        finally:
            quant_t[0] += time.perf_counter() - q0

    runners = extraction_runners(manager, db, writer, index)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reconcile.reconcile_space = timed_reconcile
    try:
        handles = run_jobs(runners, "audio", [
            (JobType.DATA_EXTRACTION, {"inference_id": WHISPER_MODEL}),
            (JobType.DATA_EXTRACTION, {"inference_id": CLAP_MODEL}),
            (JobType.VECTOR_QUANT_RECONCILE, {})])
        torch.cuda.synchronize()
    finally:
        reconcile.reconcile_space = reconcile_space
    audio_s = sum(s for _, s, _ in clips)
    window_s = sum(min(s, whisper.CHUNK_SECONDS) for _, s, _ in clips)
    jobs, reports = {}, {}
    for model, handle in zip((WHISPER_MODEL, CLAP_MODEL), handles):
        report, wall = handle.result["report"], handle.result["wall_s"]
        quant = quant_t[0] if model == CLAP_MODEL else 0.0
        reports[model] = report
        jobs[model] = {
            "job_wall_s": wall, "processed": report.processed, "files_per_s": report.processed / wall,
            "audio_s_per_s": audio_s / wall, "load_stall_s": report.data_load_time,
            "inference_s": report.inference_time, "quant_reconcile_s": quant,
            "db_index_writes_s": wall - report.data_load_time - report.inference_time - quant}
    jobs[WHISPER_MODEL]["audio_s_in_30s_windows_per_s"] = window_s / jobs[WHISPER_MODEL]["job_wall_s"]
    return {
        "part": "a_build", "card": smi, "files": len(clips), "audio_seconds": audio_s,
        "stereo_44k_files": sum(s for *_, s in clips), "seconds_range": AUDIO_SECONDS,
        "load_and_prewarm_s": load_s, "clap_dim": emb.model.cfg.embed_dim, "jobs": jobs,
        "reconcile_job_s": handles[2].result["wall_s"],
        "b3_launches_by_route": read_routes(counters).get("mha", {}),
        "launches": {fn.__name__: fn.launches for fn in counters},
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30, "reports": reports,
    }


def _audio_checks(db, writer, index, reports, dim: int) -> dict:
    """Phase 12(b): a transcript row for every item (a language of
    LANGUAGES, 0 < confidence ≤ 1, found through FTS5) and a unit CLAP
    vector for every item, its space checked as phase 11's (codes equal to
    the host codec of the stored vectors, sync_all equal to the built
    index)."""
    from panoptikon_tpu_torch.db import store
    from panoptikon_tpu_torch.models import whisper

    report = reports[WHISPER_MODEL]
    require((report.processed, report.input_errors, report.transient_errors) == (AUDIO_FILES, 0, 0),
            f"audio: whisper processed {report.processed}, {report.input_errors} input and "
            f"{report.transient_errors} transient errors")
    conn = db.reader()
    rows = conn.execute(
        """SELECT d.item_id, t.id, t.text, t.language, t.language_confidence, t.confidence
           FROM extracted_text t JOIN item_data d ON d.id = t.id
           JOIN setters s ON s.id = d.setter_id WHERE s.name = ?""", (WHISPER_MODEL,)).fetchall()
    require(len(rows) == len({r[0] for r in rows}) == AUDIO_FILES,
            f"audio: {len(rows)} transcripts for {AUDIO_FILES} items")
    langs = set(whisper.LANGUAGES)
    for item, tid, text, lang, lang_conf, conf in rows:
        require(text and lang in langs and 0 < lang_conf <= 1 and 0 < conf <= 1,
                f"audio: item {item}'s transcript {text[:40]!r} {lang} {lang_conf} {conf}")
        hits = {r[0] for r in conn.execute(
            "SELECT rowid FROM extracted_text_fts WHERE extracted_text_fts MATCH ?",
            (f'"{text.split()[0]}"',))}
        require(tid in hits, f"audio: FTS5 misses item {item}'s transcript")
    clap = _extract_checks(db, writer, index, reports[CLAP_MODEL], dim, space=CLAP_MODEL,
                           n_items=AUDIO_FILES, weight=1.0, data_offset=None)
    _, _, vectors, _ = store.load_embedding_space(conn, CLAP_MODEL, limit=AUDIO_FILES + 1)
    norms = np.linalg.norm(vectors, axis=1)
    require(bool((np.abs(norms - 1) < 1e-3).all()), f"audio: CLAP norms {norms.min()}-{norms.max()}")
    lengths = [len(r[2].split()) for r in rows]
    return {"part": "b_checks", "transcripts": len(rows), "languages": sorted({r[3] for r in rows}),
            "tokens_per_transcript": [min(lengths), float(np.mean(lengths)), max(lengths)],
            "confidence_range": [min(r[5] for r in rows), max(r[5] for r in rows)],
            "clap_norm_range": [float(norms.min()), float(norms.max())], "fts5_finds_each": True,
            "clap": clap}


def _audio_search(torch, dev, smi, counters, db, index, manager) -> dict:
    """Phase 12(c): a match_text page on a token of one transcript holds
    its item and every item whose transcript holds the token; a similar_to
    page on one item over the CLAP space ranks that item first; the serving
    path's rescored candidates over the CLAP space reach recall@10 ≥ 0.99
    against the exact f32 top-10, B1 equal to its plain version."""
    from panoptikon_tpu_torch.ops import codec, exact, int8_scan, scoring
    from panoptikon_tpu_torch.pql import model as pql
    from panoptikon_tpu_torch.pql.executor import Executor

    conn = db.reader()
    item, text, sha = conn.execute(
        """SELECT d.item_id, t.text, i.sha256 FROM extracted_text t JOIN item_data d ON d.id = t.id
           JOIN items i ON i.id = d.item_id ORDER BY d.item_id LIMIT 1""").fetchone()
    token = text.split()[0]
    holders = {r[0] for r in conn.execute(
        "SELECT d.item_id FROM extracted_text t JOIN item_data d ON d.id = t.id"
        " WHERE ' ' || t.text || ' ' LIKE ?", (f"% {token} %",))}
    ex = Executor(db, index, manager=manager, device=str(dev))
    t0 = time.perf_counter()
    res = ex.execute(pql.PqlQuery.from_json(
        {"query": {"match_text": {"match": f'"{token}"'}}, "page_size": AUDIO_FILES}))
    fts_ms = 1e3 * (time.perf_counter() - t0)
    found = {r["item_id"] for r in res.results}
    require(item in found and found == holders,
            f"audio search: match_text {token} found {len(found)} items, {len(holders)} hold it")
    t0 = time.perf_counter()
    res = ex.execute(pql.PqlQuery.from_json(
        {"query": {"similar_to": {"target": sha, "model": CLAP_MODEL}}, "page_size": K}))
    similar_ms = 1e3 * (time.perf_counter() - t0)
    require(len(res.results) == K and res.results[0]["item_id"] == item,
            f"audio search: similar_to ranks {[r['item_id'] for r in res.results[:3]]}, not {item}")
    snap = index.snapshot(CLAP_MODEL)
    n = snap.size
    x = torch.from_numpy(snap.vectors[:n]).to(dev)
    qt = x[:: max(1, n // AUDIO_RECALL_Q)][:AUDIO_RECALL_Q]
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    _, want_rows, _ = exact.topk_ascending(exact.pairwise_distance(x, qt), valid, K)
    codes = torch.from_numpy(snap.codes[:n]).to(dev)
    sumsq = scoring.row_sumsq(codes)
    qc = codec.quantize_int8(qt, snap.scale)
    _, got_rows, _ = scoring.int8_topk_rescored(codes, sumsq, valid, x, qc, qt, k=K, oversample=4,
                                                distance="cosine", scale=snap.scale, rescore=True)
    want_rows, got_rows = want_rows.cpu().numpy(), got_rows.cpu().numpy()
    rescored = float(np.mean([len(set(g) & set(w)) / K for g, w in zip(got_rows, want_rows)]))
    require(rescored >= 0.99, f"audio search: rescored recall@10 {rescored} < 0.99")
    with not_counted(counters):
        args = (codes, sumsq, valid, qc)
        gv, gi, gok = int8_scan.int8_topk(*args, k=4 * K)
        pv, pi, pok = int8_scan.int8_topk_plain(*args, k=4 * K)
        torch.cuda.synchronize()
        require(torch.equal(gi, pi) and torch.equal(gok, pok), "audio search: B1 ids differ from plain")
        b1_err = (gv - pv).abs().max().item()
        require(b1_err <= 1e-6, f"audio search: B1 max abs dist diff {b1_err}")
        b1 = dict(zip(("b1_k40_ms", "b1_k40_plain_ms"), paired_ms(
            torch, lambda: int8_scan.int8_topk(*args, k=4 * K),
            lambda: int8_scan.int8_topk_plain(*args, k=4 * K), reps=10)))
        b1.update({"b1_k40_" + key: value for key, value in scan_roofline(args, 4 * K).items()})
        b1["b1_k40_gemm_only_ms"] = gemm_only_ms(torch, args)
    return {"part": "c_search", "card": smi, "match_text_token": token,
            "match_text_items": len(found), "match_text_ms": fts_ms, "similar_to_ms": similar_ms,
            "similar_to_first_is_target": True, "clap_rows": n, "recall_queries": len(qt),
            "rescored_recall_at_10": rescored, "b1_k40_max_abs_err": b1_err, **b1}


def _whisper_window(torch, smi, counters, manager, clips) -> dict:
    """Phase 12(d): one registry window of whisper-base (4 files) split into
    the host log-mel, the encode, the language probe and the decode steps
    (host clock around synchronised parts), and the card's busy share over
    the whole window through predict (profiler); off the main path's
    counts."""
    from panoptikon_tpu_torch.models import whisper
    from panoptikon_tpu_torch.models.impls import PredictionInput, decode_wav

    impl = manager._models[WHISPER_MODEL].model
    payloads = [p.read_bytes() for p, _, _ in clips[:4]]
    steps = [0]
    step = whisper._decode_step

    def counted(*a, **k):
        steps[0] += 1
        return step(*a, **k)

    with not_counted(counters), torch.inference_mode():
        t0 = time.perf_counter()
        mel = np.stack([whisper.log_mel_spectrogram(decode_wav(p), impl.cfg.n_mels) for p in payloads])
        mel_s = time.perf_counter() - t0
        mel_t = torch.from_numpy(mel).to(impl.device)
        times = []
        for _ in range(2):  # the second pass is the one kept
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats = whisper.encode_audio(impl.params, impl.cfg, mel_t)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            idx, _ = whisper.language_probe(impl.params, impl.cfg, feats)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            prompt = whisper.prompt_tokens(impl.cfg, 4, impl.cfg.language_base + idx, impl.device)
            steps[0] = 0
            whisper._decode_step = counted
            try:
                _, lengths, _ = whisper.decode_from_feats(impl.params, impl.cfg, feats, prompt,
                                                          impl.max_tokens)
                torch.cuda.synchronize()
            finally:
                whisper._decode_step = step
            times = [t1 - t0, t2 - t1, time.perf_counter() - t2]
        inputs = [PredictionInput(file=p) for p in payloads]
        impl.predict(inputs)
        wall, busy = busy_share(torch, lambda: impl.predict(inputs))
    return {"part": "d_whisper_window", "card": smi, "files": len(payloads), "mel_host_s": mel_s,
            "encode_ms": 1e3 * times[0], "probe_ms": 1e3 * times[1], "decode_ms": 1e3 * times[2],
            "decode_steps": steps[0], "decode_ms_per_step": 1e3 * times[2] / steps[0],
            "lengths": lengths.tolist(), "window_wall_s": wall, "device_busy_share_window": busy,
            "device_idle_share_window": 1 - busy}


def audio_pair_path(torch, dev, smi) -> dict:
    """Phase 12(e): AUDIO_PAIR_FILES of the seeded files through the impls on
    the card and on the CPU (the card impls' weights copied over: CUDA and
    CPU generators draw different random weights): CLAP embeddings and
    whisper-base's encoder features at cosine ≥ 0.999 a row; the language
    probabilities within AUDIO_PROB_ATOL, the language equal wherever the
    card's top-2 margin exceeds twice the observed difference; the decoder
    steps teacher-forced on the card's tokens at cosine ≥ 0.999 a position,
    the argmax equal wherever the card's top-2 logit margin exceeds twice
    the max abs error; the CPU's free-running tokens equal to the card's up
    to the first position whose margin is below that."""
    import tempfile

    from panoptikon_tpu_torch.models import impls, whisper
    from panoptikon_tpu_torch.models.impls import PredictionInput, decode_wav, npy

    with tempfile.TemporaryDirectory(dir=scratch_dir()) as root:
        clips = write_audio_folder(Path(root), AUDIO_PAIR_FILES, SEED + 120)
        payloads = [p.read_bytes() for p, _, _ in clips]
    require(any(s for *_, s in clips), "audio pair: no stereo 44.1 kHz file")
    inputs = [PredictionInput(file=p) for p in payloads]
    out = {"part": "e_card_equals_cpu", "card": smi, "files": len(payloads)}
    card_clap, cpu_clap = impls.ClapImpl("clap-base"), impls.ClapImpl("clap-base", device="cpu")
    card_clap.load()
    cpu_clap.params = _tree_to(card_clap.params, "cpu")
    t0 = time.perf_counter()
    cpu_rows = np.stack([npy.parse_npy_embedding(o) for o in cpu_clap.predict(inputs)])
    out["cpu_clap_s"] = time.perf_counter() - t0
    card_rows = np.stack([npy.parse_npy_embedding(o) for o in card_clap.predict(inputs)])
    cos = cosines(card_rows, cpu_rows)
    require(float(cos.min()) >= 0.999, f"audio pair: CLAP min cosine card vs CPU {cos.min()}")
    out["clap_min_cosine"] = float(cos.min())
    del card_clap, cpu_clap

    card, cpu = impls.WhisperImpl("whisper-base"), impls.WhisperImpl("whisper-base", device="cpu")
    card.load()
    cpu.params = _tree_to(card.params, "cpu")
    cfg = card.cfg
    mel = np.stack([whisper.log_mel_spectrogram(decode_wav(p), cfg.n_mels) for p in payloads])
    with torch.inference_mode():
        feats = {}
        for name, impl in (("card", card), ("cpu", cpu)):
            t0 = time.perf_counter()
            feats[name] = whisper.encode_audio(impl.params, cfg, torch.from_numpy(mel).to(impl.device))
            torch.cuda.synchronize()
            out[f"{name}_encode_s"] = time.perf_counter() - t0
        f_card, f_cpu = feats["card"].cpu().numpy(), feats["cpu"].numpy()
        cos = cosines(f_card.reshape(-1, f_card.shape[-1]), f_cpu.reshape(-1, f_cpu.shape[-1]))
        require(float(cos.min()) >= 0.999, f"audio pair: encoder min cosine card vs CPU {cos.min()}")
        out["encoder_min_cosine"] = float(cos.min())
        probs = {}
        for name, impl in (("card", card), ("cpu", cpu)):
            sot = torch.full((len(payloads), 1), cfg.sot, device=impl.device)
            logits = whisper._decoder_logits(impl.params, cfg, sot, feats[name], None)[:, 0]
            base = cfg.language_base
            probs[name] = torch.softmax(logits[:, base:base + cfg.n_langs], dim=-1).cpu().numpy()
        diff = float(np.abs(probs["card"] - probs["cpu"]).max())
        require(diff <= AUDIO_PROB_ATOL, f"audio pair: language probabilities {diff} apart")
        top2 = np.sort(probs["card"], axis=-1)[:, -2:]
        lang_decided = top2[:, 1] - top2[:, 0] > 2 * diff
        same = probs["card"].argmax(-1) == probs["cpu"].argmax(-1)
        require(bool(same[lang_decided].all()), f"audio pair: languages differ {same} where decided")
        lang = torch.from_numpy(cfg.language_base + probs["card"].argmax(-1).astype(np.int32))
        prompt = whisper.prompt_tokens(cfg, len(payloads), lang.to(dev), dev)
        tokens, lengths, _ = whisper.decode_from_feats(card.params, cfg, feats["card"], prompt,
                                                       card.max_tokens)
        tokens = tokens.cpu()
        logits = {}
        for name, impl in (("card", card), ("cpu", cpu)):
            t0 = time.perf_counter()
            logits[name] = _teacher_forced(torch, impl.params, cfg, feats[name],
                                           tokens.to(impl.device))
            out[f"{name}_teacher_forced_s"] = time.perf_counter() - t0
        got, want = logits["cpu"], logits["card"]
        cos = cosines(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]))
        require(float(cos.min()) >= 0.999, f"audio pair: teacher-forced logits min cosine {cos.min()}")
        err = float(np.abs(got - want).max())
        top2 = np.sort(want, axis=-1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
        decided = margin > 2 * err
        agree = got.argmax(-1) == want.argmax(-1)
        require(bool(agree[decided].all()), "audio pair: the argmax differs where the margin is wide")
        t0 = time.perf_counter()
        cpu_tokens = whisper.decode_from_feats(cpu.params, cfg, feats["cpu"], prompt.cpu(),
                                               cpu.max_tokens)[0]
        out["cpu_decode_s"] = time.perf_counter() - t0
        splits = []
        for j in range(len(payloads)):
            low = np.flatnonzero(margin[j, 3:] <= 2 * err)
            first = 3 + (int(low[0]) if low.size else cfg.n_text_ctx)
            require(torch.equal(cpu_tokens[j, : first + 1], tokens[j, : first + 1]),
                    f"audio pair: row {j}'s free-running tokens split before position {first}")
            splits.append(first if low.size else None)
    out.update({"language_prob_max_abs_diff": diff, "languages_decided": int(lang_decided.sum()),
                "languages_equal": int(same.sum()),
                "teacher_forced_min_cosine": float(cos.min()), "logits_max_abs_err": err,
                "positions_decided": int(decided.sum()), "positions": int(decided.size),
                "first_low_margin_position": splits, "card_lengths": lengths.tolist()})
    return out


def _teacher_forced(torch, params, cfg, feats, tokens):
    """whisper's incremental step over token rows (B, L) on the features'
    device (the whisper decoder's or the captioner's): logits (B, L - 1,
    vocab) as NumPy."""
    from panoptikon_tpu_torch.models import whisper

    b, length = tokens.shape
    ck, cv = whisper._cross_heads(params, cfg, feats)
    sk = torch.zeros((cfg.n_text_layers, b, length, cfg.n_text_state), dtype=torch.bfloat16,
                     device=feats.device)
    sv = torch.zeros_like(sk)
    return np.stack([whisper._decode_step(params, cfg, tokens[:, i], i, sk, sv, ck, cv,
                                          length).cpu().numpy() for i in range(length - 1)], axis=1)


def audio_attention(torch, dev, smi, counters) -> dict:
    """Phase 12(f): B3 at the audio path's shapes (AUDIO_ATTN_CASES), off
    the main path's counts: against mha_plain (≤ 2e-2 max abs), on the
    tensor cores, timed kernel/plain/plain/kernel beside SDPA and the
    bound."""
    from panoptikon_tpu_torch.ops import vit_attention

    gen = torch.Generator(device=dev).manual_seed(SEED + 121)
    shapes = {}
    with not_counted(counters):
        for name, (b, nq, nkv, h, d, causal, fused) in AUDIO_ATTN_CASES.items():
            if fused:  # q, k, v the views of one fused qkv, as the encoder hands them
                q, k, v = (t.view(b, nq, h, d) for t in torch.randn(
                    (b, nq, 3 * h * d), generator=gen, device=dev).to(torch.bfloat16).split(h * d, -1))
            else:
                q, k, v = (torch.randn((b, n, h, d), generator=gen, device=dev).to(torch.bfloat16)
                           for n in (nq, nkv, nkv))
            tc = vit_attention.mha.routes["tensor_core"]
            got = vit_attention.mha(q, k, v, causal=causal)
            require(vit_attention.mha.routes["tensor_core"] == tc + 1, f"mha {name}: not on the tensor cores")
            want = vit_attention.mha_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            require(torch.isfinite(got.float()).all().item() and err <= 2e-2,
                    f"mha {name}: max abs diff {err} > 2e-2")
            ms, plain_ms = paired_ms(torch, lambda: vit_attention.mha(q, k, v, causal=causal),
                                     lambda: vit_attention.mha_plain(q, k, v, causal=causal), reps=10)
            shapes[name] = {"shape": [b, nq, nkv, h, d], "causal": causal, "max_abs_err": err,
                            "ms": ms, "plain_ms": plain_ms,
                            **attention_roofline(q, k, v, got, causal),
                            "library_ms": cuda_ms(torch, lambda: sdpa(torch, q, k, v, causal), reps=10)}
    return {"part": "f_b3_audio_shapes", "card": smi, "shapes": shapes}


def write_image_folder(root: Path, n: int, seed: int):
    """n seeded TAG_SIZE² RGB images under ``root`` as binary PPM files
    written with NumPy (no PIL on the card machine): a 7 × 7 grid of seeded
    colours with seeded noise on it. Returns (paths, pixels (n, S, S, 3)
    uint8)."""
    rng = np.random.default_rng(seed)
    s, g = TAG_SIZE, 7
    coarse = rng.integers(0, 256, size=(n, g, g, 3), dtype=np.int16)
    pixels = np.repeat(np.repeat(coarse, s // g, axis=1), s // g, axis=2)
    pixels += rng.integers(-24, 25, size=pixels.shape, dtype=np.int16)
    pixels = np.clip(pixels, 0, 255).astype(np.uint8)
    header = f"P6\n{s} {s}\n255\n".encode()
    paths = []
    for i, img in enumerate(pixels):
        path = root / f"img{i:04d}.ppm"
        path.write_bytes(header + img.tobytes())
        paths.append(path)
    return paths, pixels


def clip_normalize(pixels):
    """uint8 (…, S, S, 3) → f32 normalised as impls.decode_image normalises
    a decoded S × S image (its resize and crop are the identity there)."""
    from panoptikon_tpu_torch.models.impls import CLIP_MEAN, CLIP_STD

    return (pixels.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD


TAG_MAP_KEYS = {"namespace", "tags", "mcut", "rating_severity", "metadata", "metadata_score"}


def tag_map_shape(out) -> bool:
    """The tagger output shape the extraction job's tags handler ingests."""
    return (isinstance(out, dict) and set(out) == TAG_MAP_KEYS
            and [c for c, _ in out["tags"]] == ["rating", "character", "general"]
            and all(isinstance(m, dict) for _, m in out["tags"]))


def tag_path(torch, dev, smi, counters) -> list:
    """Phase 13: (a) TAG_IMAGES seeded PPM images scanned through the
    JobQueue; (b) tags/vit-tagger through the manager in windows of 32, in
    bf16 and, through a user TOML overlay, in int8; (c) the bf16 tag maps as
    a SQLite dump keyed by md5, the tagmatch job through the JobQueue and
    match_tags pages through Executor.execute; (d) the captioner and the VLM
    tagger on CAPTION_IMAGES of the arrays. Returns the records and the
    first TAG_PAIR_IMAGES arrays (for 13(e))."""
    import tempfile

    from panoptikon_tpu_torch.db import store
    from panoptikon_tpu_torch.db.connection import Database
    from panoptikon_tpu_torch.db.writer import IndexWriter
    from panoptikon_tpu_torch.index import VectorIndex
    from panoptikon_tpu_torch.jobs import scan
    from panoptikon_tpu_torch.jobs.queue import ChangeSummary, JobType

    with tempfile.TemporaryDirectory(dir=scratch_dir()) as root:
        folder = Path(root) / "images"
        folder.mkdir()
        t0 = time.perf_counter()
        paths, pixels = write_image_folder(folder, TAG_IMAGES, SEED + 130)
        write_s = time.perf_counter() - t0
        folder_mb = sum(p.stat().st_size for p in paths) / 1e6
        arrays = clip_normalize(pixels)
        del pixels
        db = Database(Path(root) / "db", "tags")
        writer = IndexWriter(db)
        manager = text_manager()
        overlay = None
        try:
            index = VectorIndex()
            writer.call(lambda conn: store.add_folder(conn, str(folder)))

            def run_rescan(handle):
                counts = scan.rescan_folders(db, writer, folders=handle.params.get("folders"),
                                             cancelled=lambda: handle.cancelled)
                handle.result = counts.__dict__
                return ChangeSummary(wrote_data=counts.new_files > 0)

            t0 = time.perf_counter()
            scanned = run_jobs({JobType.FOLDER_RESCAN: run_rescan}, "tags",
                               [(JobType.FOLDER_RESCAN, {})])[0].result
            scan_s = time.perf_counter() - t0
            require(scanned["new_files"] == TAG_IMAGES and scanned["errors"] == 0,
                    f"tags: scanned {scanned}")
            folder_rec = {"images": TAG_IMAGES, "size": TAG_SIZE, "folder_mb": folder_mb,
                          "write_ppm_s": write_s, "scan_job_s": scan_s, "scanned": scanned}
            tagger, bf16_maps = _tagger_run(torch, dev, smi, counters, manager, TAG_MODEL, arrays)
            tagger.update(folder_rec)
            dump = Path(root) / "dump.sqlite"
            dump_rows = _write_tag_dump(db, dump, paths, bf16_maps)
            overlay = text_manager(
                "allow_override = true\n"
                "[group.tags.inference_ids.vit-tagger]\n"
                'config.model_arch = "ViT-B-32"\nconfig.precision = "int8"\n'
                "[group.tagmatch.metadata.input_spec]\n"
                'handler = "md5"\n'
                "[group.tagmatch.inference_ids.local-dump]\n"
                f'config.dump_path = "{dump}"\n', root)
            int8_run, _ = _tagger_run(torch, dev, smi, counters, overlay, TAG_MODEL, arrays,
                                      bf16_impl=manager._models[TAG_MODEL].model)
            build = _tag_build(torch, dev, smi, db, writer, index, overlay, dump, dump_rows)
            captions = _caption_run(torch, dev, smi, counters, manager, arrays[:CAPTION_IMAGES])
        finally:
            manager.shutdown()
            if overlay is not None:
                overlay.shutdown()
            writer.close()
    return [tagger, int8_run, build, captions], arrays[:TAG_PAIR_IMAGES]


def _tagger_run(torch, dev, smi, counters, manager, model, arrays, bf16_impl=None):
    """Phase 13(b): ``model`` loaded through ``manager`` with prewarm, then
    tag_arrays over ``arrays`` in windows of its default batch (general
    tags at each image's mcut); images/s, ms a window, the busy share over a
    window, peak memory. The bf16 run (``bf16_impl`` None) also holds one
    call of TAG_SLICE_CHECK arrays equal to calls of at most the batch cap;
    the int8 run holds its raw features to the bf16 tower on the same
    dequantized weights, and reports them against ``bf16_impl``'s, at cosine
    ≥ 0.999 a row on images the calibration slice never saw. Returns the
    record and the tag maps."""
    from panoptikon_tpu_torch.models import clip

    t0 = time.perf_counter()
    manager.load_model(model, cache_key=TAG_CACHE_KEY, lru_size=4, prewarm=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    entry = manager._models[model]
    impl = entry.model
    precision = "bf16" if bf16_impl is None else "int8"
    require(entry.default_batch == TAG_WINDOW and impl.precision == precision
            and impl.cfg == dataclasses.replace(clip.CONFIGS["ViT-B-32"], matmul_precision=precision)
            and impl.device.type == dev.type and impl._act_scales is None,
            f"tags: {model} as the registry (and overlay) define it, {precision}")
    # No threshold: each image's general tags are cut at its mcut, so the
    # sets differ between images (with random weights most probabilities
    # clear the group's default_threshold of 0.1).
    configs = [{}] * TAG_WINDOW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    maps, window_s = [], []
    t0 = time.perf_counter()
    for lo in range(0, len(arrays), TAG_WINDOW):
        w0 = time.perf_counter()
        window = arrays[lo : lo + TAG_WINDOW]
        maps += impl.tag_arrays(window, configs[: len(window)])
        window_s.append(time.perf_counter() - w0)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(len(maps) == len(arrays) and all(tag_map_shape(m) for m in maps),
            f"tags {precision}: {len(maps)} tag maps for {len(arrays)} images")
    rec = {"part": f"b_tagger_{precision}", "card": smi, "model": model, "images": len(arrays),
           "window": TAG_WINDOW, "load_and_prewarm_s": load_s, "wall_s": wall,
           "images_per_s": len(arrays) / wall, "window_ms_median": 1e3 * float(np.median(window_s)),
           "window_ms_range": [1e3 * min(window_s), 1e3 * max(window_s)],
           "peak_device_gib": peak, "threshold": "mcut",
           "general_tags_per_image": [min(len(dict(m["tags"])["general"]) for m in maps),
                                      float(np.mean([len(dict(m["tags"])["general"]) for m in maps])),
                                      max(len(dict(m["tags"])["general"]) for m in maps)]}
    unseen = arrays[-2 * TAG_WINDOW:]  # never in the calibrating first window
    window = arrays[:TAG_WINDOW]
    with not_counted(counters):
        wall_w, busy = busy_share(torch, lambda: impl.tag_arrays(window, configs))
        # A window's split (host clock around synchronised parts, the second
        # pass kept): the copy to the card, the trunk on it alone, the
        # probabilities (pad, copy, trunk, head, copy back), and the tag maps
        # alone (tag_arrays over those probabilities).
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            x_dev = torch.from_numpy(window).to(dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if precision == "int8":
                clip.embed_images_raw_scaled(impl.params, impl.cfg, x_dev, impl._act_scales)
            else:
                clip.embed_images_raw(impl.params, impl.cfg, x_dev)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            probs = impl.probabilities(window)
            t4 = time.perf_counter()
            impl.probabilities = lambda _images: probs
            try:
                impl.tag_arrays(window, configs)
            finally:
                del impl.probabilities
            t5 = time.perf_counter()
        rec.update({"profiled_window_s": wall_w, "device_busy_share_window": busy,
                    "window_split_ms": {"h2d": 1e3 * (t2 - t1), "trunk": 1e3 * (t3 - t2),
                                        "probabilities": 1e3 * (t4 - t3),
                                        "tag_maps": 1e3 * (t5 - t4)}})
        if bf16_impl is None:
            one = impl.raw_features(arrays[:TAG_SLICE_CHECK])
            parts = torch.cat([impl.raw_features(arrays[lo : min(lo + TAG_WINDOW, TAG_SLICE_CHECK)])
                               for lo in range(0, TAG_SLICE_CHECK, TAG_WINDOW)])
            p_one = impl.probabilities(arrays[:TAG_SLICE_CHECK])
            p_parts = np.concatenate([impl.probabilities(arrays[lo : min(lo + TAG_WINDOW,
                                                                         TAG_SLICE_CHECK)])
                                      for lo in range(0, TAG_SLICE_CHECK, TAG_WINDOW)])
            p_diff = float(np.abs(p_one - p_parts).max())
            require(torch.equal(one, parts) and p_diff <= 1e-6,
                    f"tags: {TAG_SLICE_CHECK} arrays in one call differ from calls of "
                    f"{TAG_WINDOW} (probabilities {p_diff} apart)")
            rec.update({"one_call_of": TAG_SLICE_CHECK, "equals_calls_of_at_most": TAG_WINDOW,
                        "one_call_prob_max_abs_diff": p_diff})
        else:
            got = impl.raw_features(unseen).cpu().numpy()
            bf16_cfg = dataclasses.replace(impl.cfg, matmul_precision="bf16")
            same_weights = clip.embed_images_raw(
                impl.params, bf16_cfg, torch.from_numpy(unseen).to(dev)).cpu().numpy()
            cos = cosines(got, same_weights)
            require(float(cos.min()) >= 0.999,
                    f"tags int8: raw features against bf16 (same weights) min cosine {cos.min()}")
            cos_b = cosines(got, bf16_impl.raw_features(unseen).cpu().numpy())
            rec.update({"int8_vs_bf16_same_weights_min_cosine": float(cos.min()),
                        "int8_vs_bf16_tagger_min_cosine": float(cos_b.min()),
                        "unseen_images": len(unseen)})
    return rec, maps


def _write_tag_dump(db, dump: Path, paths, maps) -> dict:
    """Phase 13(c): the tag maps as a SQLite dump ``tags(md5, namespace, name,
    confidence)`` with an md5 index, the layout Md5LookupImpl reads, keyed by
    each scanned file's md5. Returns {md5: {name: confidence}}, what the
    lookup gives each item."""
    by_path = dict(db.reader().execute(
        "SELECT f.path, i.md5 FROM files f JOIN items i ON i.id = f.item_id").fetchall())
    expected, rows = {}, []
    for path, out in zip(paths, maps):
        md5 = by_path[str(path)]
        tags = {}
        for _, cat in out["tags"]:
            tags.update(cat)
        expected[md5] = tags
        rows += [(md5, out["namespace"], name, conf) for name, conf in tags.items()]
    conn = sqlite3.connect(dump)
    conn.executescript("CREATE TABLE tags (md5 TEXT, namespace TEXT, name TEXT, confidence REAL);"
                       "CREATE INDEX tags_md5 ON tags(md5);")
    conn.executemany("INSERT INTO tags VALUES (?, ?, ?, ?)", rows)
    conn.commit()
    conn.close()
    return expected


def _tag_build(torch, dev, smi, db, writer, index, manager, dump, expected) -> dict:
    """Phase 13(c): the tagmatch job (md5 handler, the overlay's dump) on the
    JobQueue; every item holds the tags the dump gives its md5; match_tags
    pages through Executor.execute on TAG_QUERIES tags each hold exactly the
    items whose map has the tag."""
    from panoptikon_tpu_torch.jobs.queue import JobType
    from panoptikon_tpu_torch.pql import model as pql
    from panoptikon_tpu_torch.pql.executor import Executor

    meta = manager.registry.group_metadata("tagmatch")
    require((meta.get("input_spec") or {}).get("handler") == "md5", f"tagmatch metadata {meta}")
    runners = extraction_runners(manager, db, writer, index)
    handle = run_jobs(runners, "tags", [(JobType.DATA_EXTRACTION, {"inference_id": TAGMATCH_MODEL})])[0]
    report, wall = handle.result["report"], handle.result["wall_s"]
    require((report.processed, report.input_errors, report.transient_errors) == (TAG_IMAGES, 0, 0),
            f"tagmatch: processed {report.processed}, {report.input_errors} input and "
            f"{report.transient_errors} transient errors")
    conn = db.reader()
    got: dict = {}
    for md5, name, conf in conn.execute(
            """SELECT i.md5, t.name, ti.confidence FROM tags_items ti JOIN tags t ON t.id = ti.tag_id
               JOIN items i ON i.id = ti.item_id"""):
        got.setdefault(md5, {})[name] = conf
    require(got.keys() == expected.keys(), f"tagmatch: {len(got)} items tagged of {len(expected)}")
    for md5, tags in expected.items():
        require(got[md5].keys() == tags.keys() and all(
            abs(got[md5][k] - v) <= 1e-6 for k, v in tags.items()), f"tagmatch: item {md5}'s tags")
    item_of = dict(conn.execute("SELECT md5, id FROM items").fetchall())
    counts: dict = {}
    for tags in expected.values():
        for name in tags:
            counts[name] = counts.get(name, 0) + 1
    ranked = sorted(counts, key=lambda n: (-counts[n], n))
    picks = [ranked[int(i)] for i in np.linspace(0, len(ranked) - 1, min(TAG_QUERIES, len(ranked)))]
    ex = Executor(db, index, manager=manager, device=str(dev))
    page_ms, sizes = [], []
    for name in dict.fromkeys(picks):
        holders = {item_of[m] for m, tags in expected.items() if name in tags}
        t0 = time.perf_counter()
        res = ex.execute(pql.PqlQuery.from_json(
            {"query": {"match_tags": {"tags": [name]}}, "page_size": TAG_IMAGES}))
        page_ms.append(1e3 * (time.perf_counter() - t0))
        found = [r["item_id"] for r in res.results]
        require(len(found) == len(set(found)) and set(found) == holders,
                f"tags search: match_tags {name} found {len(found)} items, {len(holders)} hold it")
        sizes.append(len(found))
    return {"part": "c_tag_build", "card": smi, "job_wall_s": wall, "processed": report.processed,
            "items_per_s": report.processed / wall, "load_stall_s": report.data_load_time,
            "inference_s": report.inference_time, "dump_rows": sum(len(t) for t in expected.values()),
            "tag_rows": sum(len(t) for t in got.values()), "distinct_tags": len(counts),
            "match_tags_queries": len(sizes), "match_tags_items": sizes,
            "match_tags_ms": [min(page_ms), float(np.median(page_ms)), max(page_ms)]}


def _caption_run(torch, dev, smi, counters, manager, arrays) -> dict:
    """Phase 13(d): vlm/caption-base (windows of 8) and vlmtags/vlm-tagger
    (windows of 16) through the manager on ``arrays``: captions/s, a window's
    vision tower and decode split (the steps counted), the busy share over a
    window; every item a caption and a tag map in the tagger's shape."""
    from panoptikon_tpu_torch.models import clip, impls, whisper

    rec = {"part": "d_captioners", "card": smi, "images": len(arrays)}
    for model, key in ((CAPTION_MODEL, "caption"), (VLM_TAG_MODEL, "vlm_tags")):
        t0 = time.perf_counter()
        manager.load_model(model, cache_key=TAG_CACHE_KEY, lru_size=4, prewarm=True)
        torch.cuda.synchronize()
        entry = manager._models[model]
        impl, batch = entry.model, entry.default_batch
        require(impl.vision_cfg == clip.CONFIGS["ViT-B-32"]
                and impl.decoder_cfg.n_text_state == impl.vision_cfg.vision_width
                and impl.decoder_cfg.n_text_heads == 2 and impl.device.type == dev.type
                and batch == {"caption": 8, "vlm_tags": 16}[key]
                and impl.max_tokens == {"caption": 48, "vlm_tags": 32}[key],
                f"captioners: {model} as the registry defines it")
        load_s = time.perf_counter() - t0
        run = impl.caption_arrays if key == "caption" else impl.tag_arrays
        out = []
        t0 = time.perf_counter()
        for lo in range(0, len(arrays), batch):
            out += run(arrays[lo : lo + batch])
        wall = time.perf_counter() - t0
        if key == "caption":
            require(len(out) == len(arrays) and all(
                o["text"] and 0 < o["confidence"] <= 1 and o["language"] == "en" for o in out),
                "captioner: every item a caption")
        else:
            require(len(out) == len(arrays) and all(tag_map_shape(o) and o["namespace"] == "vlm"
                                                    and dict(o["tags"])["general"] for o in out),
                    "vlm tagger: every item a tag map in the tagger's output shape")
        steps = [0]
        step = whisper._decode_step

        def counted(*a, **k):
            steps[0] += 1
            return step(*a, **k)

        window = arrays[:batch]
        with not_counted(counters):
            for _ in range(2):  # the second pass is the one kept
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                feats = clip.encode_image_tokens(impl.vision_params, impl.vision_cfg,
                                                 torch.from_numpy(window).to(dev))
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                steps[0] = 0
                whisper._decode_step = counted
                try:
                    _, lengths, _ = impls._caption_decode(impl.decoder_params, impl.decoder_cfg,
                                                          feats, impl.max_tokens, impl._prompt_ids)
                    torch.cuda.synchronize()
                finally:
                    whisper._decode_step = step
                t3 = time.perf_counter()
            wall_w, busy = busy_share(torch, lambda: run(window))
        rec[key] = {"model": model, "window": batch, "max_tokens": impl.max_tokens,
                    "load_and_prewarm_s": load_s, "wall_s": wall, "per_s": len(arrays) / wall,
                    "window_ms": 1e3 * wall / -(-len(arrays) // batch),
                    "vision_tower_ms": 1e3 * (t2 - t1), "decode_ms": 1e3 * (t3 - t2),
                    "decode_steps": steps[0], "decode_ms_per_step": 1e3 * (t3 - t2) / steps[0],
                    "generated_tokens": (lengths - 3).tolist(),
                    "profiled_window_s": wall_w, "device_busy_share_window": busy,
                    "device_idle_share_window": 1 - busy,
                    "example": out[0]["text"][:60] if key == "caption" else
                    list(dict(out[0]["tags"])["general"])[:6]}
    return rec


def tag_pair_path(torch, dev, smi, x) -> dict:
    """Phase 13(e): the arrays ``x`` through the registry's bf16 tagger and
    captioner (ViT-B-32; the seeded weights of 13(b) and (d)) on the card and
    on the CPU, the card's weights copied (CUDA and CPU generators draw
    different random weights): raw features at
    cosine ≥ 0.999 a row; probabilities within TAG_PROB_ATOL; mcut tag sets
    equal wherever the chosen gap beats the runner-up by more than twice the
    largest probability difference; vision tokens at cosine ≥ 0.999;
    teacher-forced decoder steps at cosine ≥ 0.999 with the argmax equal
    where the margin exceeds twice the max abs error; the CPU's free-running
    tokens equal to the card's up to the first narrow margin."""
    from panoptikon_tpu_torch.models import clip, impls, whisper
    from panoptikon_tpu_torch.ops import vit_attention

    card = impls.TaggerImpl("ViT-B-32")
    card.load()
    cpu = impls.TaggerImpl("ViT-B-32", device="cpu")
    cpu.params, cpu.head, cpu.head_bias = (_tree_to(t, "cpu") for t in
                                           (card.params, card.head, card.head_bias))
    out = {"part": "e_card_equals_cpu", "card": smi, "images": len(x)}
    t0 = time.perf_counter()
    f_cpu = cpu.raw_features(x).numpy()
    out["cpu_tagger_s"] = time.perf_counter() - t0
    f_card = card.raw_features(x).cpu().numpy()
    cos = cosines(f_card, f_cpu)
    require(float(cos.min()) >= 0.999, f"tag pair: raw features min cosine card vs CPU {cos.min()}")
    p_card, p_cpu = card.probabilities(x), cpu.probabilities(x)
    diff = float(np.abs(p_card - p_cpu).max())
    require(diff <= TAG_PROB_ATOL, f"tag pair: probabilities {diff} apart")
    n_rating = len(card.rating_tags)
    held = 0
    for g, w, pc in zip(cpu.tag_arrays(x, [None] * len(x)), card.tag_arrays(x, [None] * len(x)),
                        p_card):
        probs = np.sort(pc[n_rating : n_rating + len(card.tag_vocab)])[::-1]
        gaps = np.sort(probs[:-1] - probs[1:])[::-1]
        if gaps[0] - gaps[1] > 2 * diff:
            require(dict(g["tags"])["general"].keys() == dict(w["tags"])["general"].keys(),
                    "tag pair: mcut tag sets differ where the gap is wide")
            held += 1
    out.update({"raw_features_min_cosine": float(cos.min()), "prob_max_abs_diff": diff,
                "mcut_sets_compared": held})

    del card, cpu
    cap = impls.CaptionerImpl("ViT-B-32", max_tokens=48)
    cap.load()
    cpu_cap = impls.CaptionerImpl("ViT-B-32", max_tokens=48, device="cpu")
    cpu_cap.vision_params = _tree_to(cap.vision_params, "cpu")
    cpu_cap.decoder_params = _tree_to(cap.decoder_params, "cpu")
    cfg = cap.decoder_cfg
    feats = {}
    for name, impl in (("card", cap), ("cpu", cpu_cap)):
        t0 = time.perf_counter()
        feats[name] = clip.encode_image_tokens(impl.vision_params, impl.vision_cfg,
                                               torch.from_numpy(x).to(impl.device))
        torch.cuda.synchronize()
        out[f"{name}_vision_s"] = time.perf_counter() - t0
    t_card, t_cpu = feats["card"].cpu().numpy(), feats["cpu"].numpy()
    cos = cosines(t_card.reshape(-1, t_card.shape[-1]), t_cpu.reshape(-1, t_cpu.shape[-1]))
    require(float(cos.min()) >= 0.999, f"tag pair: vision tokens min cosine card vs CPU {cos.min()}")
    out["vision_tokens_min_cosine"] = float(cos.min())
    with torch.inference_mode():
        tokens, lengths, _ = impls._caption_decode(cap.decoder_params, cfg, feats["card"],
                                                   cap.max_tokens)
        tokens = tokens.cpu()
        logits = {}
        for name, impl in (("card", cap), ("cpu", cpu_cap)):
            t0 = time.perf_counter()
            logits[name] = _teacher_forced(torch, impl.decoder_params, cfg, feats[name],
                                           tokens.to(impl.device))
            out[f"{name}_teacher_forced_s"] = time.perf_counter() - t0
        got, want = logits["cpu"], logits["card"]
        cos = cosines(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]))
        require(float(cos.min()) >= 0.999, f"tag pair: teacher-forced logits min cosine {cos.min()}")
        err = float(np.abs(got - want).max())
        top2 = np.sort(want, axis=-1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
        decided = margin > 2 * err
        require(bool((got.argmax(-1) == want.argmax(-1))[decided].all()),
                "tag pair: the decoder's argmax differs where the margin is wide")
        # The same rows whole through _decoder_logits on the card: caption-base's
        # decoder is 768 wide with 2 heads, so its causal self-attention and its
        # cross-attention over the 50 vision tokens launch B3 at D 384, on the
        # CUDA-core route, once each a layer. Held to the step logits.
        routes = dict(vit_attention.mha.routes)
        full = whisper._decoder_logits(cap.decoder_params, cfg, tokens.to(dev), feats["card"],
                                       None)[:, :-1].cpu().numpy()
        grew = {path: vit_attention.mha.routes[path] - routes[path] for path in routes}
        require(grew == {"tensor_core": 0, "cuda_core": 2 * cfg.n_text_layers},
                f"tag pair: _decoder_logits at D 384 launched B3 {grew}")
        cos_full = cosines(full.reshape(-1, full.shape[-1]), want.reshape(-1, want.shape[-1]))
        require(float(cos_full.min()) >= 0.999,
                f"tag pair: _decoder_logits against the step logits min cosine {cos_full.min()}")
        out["decoder_logits_d384"] = {
            "head_dim": cfg.n_text_state // cfg.n_text_heads, "b3_launches_by_route": grew,
            "min_cosine_vs_steps": float(cos_full.min()),
            "max_abs_err_vs_steps": float(np.abs(full - want).max())}
        cpu_tokens = impls._caption_decode(cpu_cap.decoder_params, cfg, feats["cpu"],
                                           cap.max_tokens)[0]
        splits = []
        for j in range(len(x)):
            low = np.flatnonzero(margin[j, 2:] <= 2 * err)
            first = 2 + (int(low[0]) if low.size else cap.max_tokens)
            require(torch.equal(cpu_tokens[j, : first + 1], tokens[j, : first + 1]),
                    f"tag pair: row {j}'s free-running tokens split before position {first}")
            splits.append(first if low.size else None)
    out.update({"teacher_forced_min_cosine": float(cos.min()), "logits_max_abs_err": err,
                "positions_decided": int(decided.sum()), "positions": int(decided.size),
                "first_low_margin_position": splits, "card_lengths": lengths.tolist()})
    return out


def tag_kernels(torch, dev, smi, counters) -> dict:
    """Phase 13(f): B3, B4 and B5 at the tagger's shapes, off the main path's
    counts: B3 bf16 ≤ 2e-2 max abs from mha_plain, B4 (int8 out) and B5 at
    most one code apart and at most 0.5 % of codes apart, the attention on
    the tensor cores; each timed kernel/plain/plain/kernel beside the bound,
    B3 beside SDPA."""
    from panoptikon_tpu_torch.ops import ln_quant, vit_attention

    gen = torch.Generator(device=dev).manual_seed(SEED + 131)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    out = {"part": "f_kernels_at_tagger_shapes", "card": smi}
    with not_counted(counters):
        b, n, h, d = TAG_ATTN_SHAPE
        q, k, v = (randn(b, n, h, d) for _ in range(3))
        tc = vit_attention.mha.routes["tensor_core"]
        got = vit_attention.mha(q, k, v)
        require(vit_attention.mha.routes["tensor_core"] == tc + 1, "tags B3: not on the tensor cores")
        want = vit_attention.mha_plain(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        require(torch.isfinite(got.float()).all().item() and err <= 2e-2,
                f"tags B3: max abs diff {err} > 2e-2")
        ms, plain_ms = paired_ms(torch, lambda: vit_attention.mha(q, k, v),
                                 lambda: vit_attention.mha_plain(q, k, v))
        out["mha"] = {"shape": [b, n, n, h, d], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      **attention_roofline(q, k, v, got),
                      "library_ms": cuda_ms(torch, lambda: sdpa(torch, q, k, v))}
        qkv = randn(b, n, 3 * h * d)
        scale = torch.tensor(3.0, device=dev)
        tc = vit_attention.mha_qkv.routes["tensor_core"]
        got = vit_attention.mha_qkv(qkv, heads=h, out_scale=scale)
        require(vit_attention.mha_qkv.routes["tensor_core"] == tc + 1,
                "tags B4: not on the tensor cores")
        want = vit_attention.mha_qkv_plain(qkv, heads=h, out_scale=scale)
        torch.cuda.synchronize()
        codes = require_codes(torch, got, want, "tags B4")
        ms, plain_ms = paired_ms(torch, lambda: vit_attention.mha_qkv(qkv, heads=h, out_scale=scale),
                                 lambda: vit_attention.mha_qkv_plain(qkv, heads=h, out_scale=scale))
        parts = qkv.view(b, n, 3, h, d).unbind(2)
        out["mha_qkv"] = {"shape": [b, n, h, d], "int8_out": True, "max_abs_err": codes, "ms": ms,
                          "plain_ms": plain_ms, **attention_roofline(*parts, got),
                          "library_ms": None}
        rows, width = TAG_LN_SHAPE
        x = randn(rows, width) * 3
        g, beta = randn(width, dtype=torch.float32), randn(width, dtype=torch.float32)
        s = torch.tensor(4.2, device=dev)
        got = ln_quant.ln_quant_2d(x, g, beta, s)
        want = ln_quant.ln_quant_plain(x, g, beta, s)
        torch.cuda.synchronize()
        codes = require_codes(torch, got, want, "tags B5")
        ms, plain_ms = paired_ms(torch, lambda: ln_quant.ln_quant_2d(x, g, beta, s),
                                 lambda: ln_quant.ln_quant_plain(x, g, beta, s))
        out["ln_quant"] = {"shape": [rows, width], "max_abs_err": codes, "ms": ms,
                           "plain_ms": plain_ms,
                           **roofline(LN_OPS_PER_ELEMENT * rows * width, "f32",
                                      nbytes(x, g, beta, s) + rows * width),
                           "library_ms": None}
    return out


# Phase 14 (OCR, ROADMAP A.11c): the digit font the seeded pages are drawn in
# (3 × 5 glyphs at twice their size, OCR_LINE_PITCH rows a line).
DIGIT_GLYPHS = {
    "0": ("111", "101", "101", "101", "111"), "1": ("010", "110", "010", "010", "111"),
    "2": ("111", "001", "111", "100", "111"), "3": ("111", "001", "111", "001", "111"),
    "4": ("101", "101", "111", "001", "001"), "5": ("111", "100", "111", "001", "111"),
    "6": ("111", "100", "111", "101", "111"), "7": ("111", "001", "010", "010", "010"),
    "8": ("111", "101", "111", "101", "111"), "9": ("111", "101", "111", "001", "111"),
}
OCR_LINE_PITCH, OCR_DIGITS = 18, (8, 60)
# The port's OcrImpl with its one change for the card machine, which has no
# PIL: pages decode from binary PGM with NumPy. chip_smoke writes it to a
# folder that the registry overlay names in impl_dirs (models/discovery.py).
PGM_OCR_IMPL = '''"""OcrImpl reading binary PGM (P5, 8-bit) pages with NumPy."""

import re

import numpy as np

from panoptikon_tpu_torch.models.impls import OcrImpl

IMPL_CLASS = "PgmOcrImpl"
_HEADER = re.compile(rb"P5\\s+(\\d+)\\s+(\\d+)\\s+255\\s")


class PgmOcrImpl(OcrImpl):
    @staticmethod
    def decode_gray(payload: bytes) -> np.ndarray:
        m = _HEADER.match(payload)
        if m is None:
            raise ValueError("not an 8-bit binary PGM")
        w, h = int(m.group(1)), int(m.group(2))
        return np.frombuffer(payload, np.uint8, w * h, m.end()).reshape(h, w)
'''


def write_page_folder(root: Path, n: int, seed: int):
    """n seeded grayscale pages OCR_PAGE_WIDTH wide under ``root`` as binary
    PGM files written with NumPy: OCR_LINES lines a page of OCR_DIGITS digits
    each (every glyph row then holds ink in every digit, so each line clears
    segment_lines' 2 % row threshold), dark ink at a seeded level on a
    seeded light ground. Returns (paths, pages, lines a page)."""
    rng = np.random.default_rng(seed)
    glyphs = [np.kron(np.array([[c == "1" for c in row] for row in DIGIT_GLYPHS[str(d)]]),
                      np.ones((2, 2), bool)) for d in range(10)]
    w = OCR_PAGE_WIDTH
    paths, pages, counts = [], [], []
    for i in range(n):
        lines = int(rng.integers(OCR_LINES[0], OCR_LINES[1] + 1))
        gray = np.full((2 * 16 + lines * OCR_LINE_PITCH, w), int(rng.integers(220, 256)), np.uint8)
        ink = int(rng.integers(0, 48))
        for j in range(lines):
            y, x = 16 + j * OCR_LINE_PITCH, int(rng.integers(8, 48))
            for d in rng.integers(0, 10, size=int(rng.integers(OCR_DIGITS[0], OCR_DIGITS[1] + 1))):
                gray[y : y + 10, x : x + 6][glyphs[d]] = ink
                x += 8
        path = root / f"page{i:04d}.pgm"
        path.write_bytes(f"P5\n{w} {gray.shape[0]}\n255\n".encode() + gray.tobytes())
        paths.append(path)
        pages.append(gray)
        counts.append(lines)
    return paths, pages, counts


def ocr_path(torch, dev, smi, counters):
    """Phase 14: (a) OCR_PAGES seeded PGM pages scanned by a FOLDER_RESCAN job
    (and the first OCR_ATTN_PAGES, copied to a folder of their own, into a
    second DB); (b) doctr/ocr-default over every page and doctr/ocr-attn over
    the second DB's through the JobQueue and run_extraction_job, in windows
    of the registry's 16 pages, the impls loaded by the manager with prewarm
    through a registry overlay whose impl_dirs give the port's OcrImpl a PGM
    decode; (c) the hard checks and OCR_QUERIES match_text pages. Returns the
    records and the first OCR_PAIR_PAGES pages (for 14(d))."""
    import shutil
    import tempfile

    from panoptikon_tpu_torch.db import store
    from panoptikon_tpu_torch.db.connection import Database
    from panoptikon_tpu_torch.db.writer import IndexWriter
    from panoptikon_tpu_torch.index import VectorIndex
    from panoptikon_tpu_torch.jobs import scan
    from panoptikon_tpu_torch.jobs.queue import ChangeSummary, JobType
    from panoptikon_tpu_torch.models import ocr

    with tempfile.TemporaryDirectory(dir=scratch_dir()) as root:
        root = Path(root)
        folders = {"ocr": root / "pages", "ocr_attn": root / "attn_pages"}
        for folder in folders.values():
            folder.mkdir()
        t0 = time.perf_counter()
        paths, pages, counts = write_page_folder(folders["ocr"], OCR_PAGES, SEED + 140)
        write_s = time.perf_counter() - t0
        for path in paths[:OCR_ATTN_PAGES]:
            shutil.copy(path, folders["ocr_attn"] / path.name)
        found = [len(ocr.segment_lines(g)) for g in pages]
        require(found == counts, "ocr pages: segment_lines finds other lines than were drawn")
        impl_dir = root / "impls"
        impl_dir.mkdir()
        (impl_dir / "pgm_ocr.py").write_text(PGM_OCR_IMPL)
        manager = text_manager(
            f'allow_override = true\nimpl_dirs = ["{impl_dir}"]\n'
            "[group.doctr.inference_ids.ocr-default]\n"
            'config.impl_class = "PgmOcrImpl"\nconfig.model_arch = "crnn-base"\n'
            "[group.doctr.inference_ids.ocr-attn]\n"
            'config.impl_class = "PgmOcrImpl"\nconfig.model_arch = "attn-base"\n'
            'config.recognizer = "attn"\n', root)
        sides = {}
        try:
            for name, folder in folders.items():
                db = Database(root / "db", name)
                sides[name] = (db, IndexWriter(db), VectorIndex())
            folder_rec = {"pages": OCR_PAGES, "width": OCR_PAGE_WIDTH, "write_pgm_s": write_s,
                          "folder_mb": sum(p.stat().st_size for p in paths) / 1e6,
                          "lines_a_page": [min(counts), float(np.mean(counts)), max(counts)],
                          "pages_over_16_lines": sum(c > 16 for c in counts)}
            for name, (db, writer, _) in sides.items():
                writer.call(lambda conn, f=folders[name]: store.add_folder(conn, str(f)))

                def run_rescan(handle, db=db, writer=writer):
                    got = scan.rescan_folders(db, writer, folders=handle.params.get("folders"),
                                              cancelled=lambda: handle.cancelled)
                    handle.result = got.__dict__
                    return ChangeSummary(wrote_data=got.new_files > 0)

                t0 = time.perf_counter()
                scanned = run_jobs({JobType.FOLDER_RESCAN: run_rescan}, name,
                                   [(JobType.FOLDER_RESCAN, {})])[0].result
                want = OCR_PAGES if name == "ocr" else OCR_ATTN_PAGES
                require(scanned["new_files"] == want and scanned["errors"] == 0,
                        f"ocr: {name} scanned {scanned}")
                folder_rec[f"scan_job_s_{name}"] = time.perf_counter() - t0
            build = _ocr_build(torch, dev, smi, counters, manager, sides)
            build.update(folder_rec)
            checks = _ocr_checks(torch, dev, smi, counters, manager, sides, paths, pages, counts)
        finally:
            manager.shutdown()
            for _, writer, _ in sides.values():
                writer.close()
    return [build, checks], pages[:OCR_PAIR_PAGES]


def _ocr_build(torch, dev, smi, counters, manager, sides) -> dict:
    """Phase 14(b): both ids loaded through the manager with prewarm, then
    the two DATA_EXTRACTION jobs on the JobQueue: pages/s, lines/s, each
    job's split, B3's launches by route, peak memory."""
    from panoptikon_tpu_torch.jobs.queue import JobType
    from panoptikon_tpu_torch.models import ocr
    from panoptikon_tpu_torch.models.impls import OcrImpl

    t0 = time.perf_counter()
    for model in (OCR_MODEL, OCR_ATTN_MODEL):
        manager.load_model(model, cache_key=OCR_CACHE_KEY, lru_size=2, prewarm=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ctc, attn = manager._models[OCR_MODEL], manager._models[OCR_ATTN_MODEL]
    for entry, recognizer in ((ctc, "ctc"), (attn, "attn")):
        impl = entry.model
        require(type(impl).__name__ == "PgmOcrImpl" and isinstance(impl, OcrImpl)
                and impl.recognizer == recognizer and impl.cfg == ocr.CONFIGS["crnn-base"]
                and entry.default_batch == 16 and impl.batch_ladder[-1] == 16
                and impl.device.type == dev.type, f"ocr: the {recognizer} reader as defined")
    require(attn.model.attn_cfg == ocr.ATTN_CONFIGS["attn-base"], "ocr: attn-base's decoder")
    jobs = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name, model in (("ocr", OCR_MODEL), ("ocr_attn", OCR_ATTN_MODEL)):
        db, writer, index = sides[name]
        handle = run_jobs(extraction_runners(manager, db, writer, index), name,
                          [(JobType.DATA_EXTRACTION, {"inference_id": model})])[0]
        report, wall = handle.result["report"], handle.result["wall_s"]
        n = OCR_PAGES if name == "ocr" else OCR_ATTN_PAGES
        require((report.processed, report.input_errors, report.transient_errors) == (n, 0, 0),
                f"ocr: {model} processed {report.processed}, {report.input_errors} input and "
                f"{report.transient_errors} transient errors")
        jobs[model] = {"pages": n, "job_wall_s": wall, "pages_per_s": n / wall,
                       "load_stall_s": report.data_load_time, "inference_s": report.inference_time,
                       "db_writes_s": wall - report.data_load_time - report.inference_time}
    return {"part": "a_b_build", "card": smi, "load_and_prewarm_s": load_s, "jobs": jobs,
            "b3_launches_by_route": read_routes(counters).get("mha", {}),
            "launches": {fn.__name__: fn.launches for fn in counters},
            "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}


def _ocr_checks(torch, dev, smi, counters, manager, sides, paths, pages, counts) -> dict:
    """Phase 14(c): every item its setter's item_data row and a text row (or
    the reference's empty-text output, a placeholder), the text equal to a
    direct read_arrays call on the same pages in the job's windows, lines/s
    from the pages' line counts; OCR_QUERIES match_text pages through
    Executor.execute, each on a substring of one item's text, holding that
    item and equal to the CPU executor's page; one window's split."""
    from panoptikon_tpu_torch.models import ocr, whisper
    from panoptikon_tpu_torch.pql import model as pql
    from panoptikon_tpu_torch.pql.executor import Executor

    rec = {"part": "c_checks", "card": smi}
    page_of = {str(p): g for p, g in zip(paths, pages)}
    lines_of = {str(p): c for p, c in zip(paths, counts)}
    texts, expected = {}, {}
    with not_counted(counters):
        for name, model in (("ocr", OCR_MODEL), ("ocr_attn", OCR_ATTN_MODEL)):
            db = sides[name][0]
            impl = manager._models[model].model
            conn = db.reader()
            items = conn.execute("SELECT i.id, f.filename FROM items i JOIN files f "
                                 "ON f.item_id = i.id ORDER BY i.id").fetchall()
            rows = {r[0]: r[1:] for r in conn.execute(
                """SELECT d.item_id, d.is_placeholder, t.text, t.confidence FROM item_data d
                   JOIN setters s ON s.id = d.setter_id LEFT JOIN extracted_text t ON t.id = d.id
                   WHERE s.name = ? AND d.data_type = 'text'""", (model,))}
            require(len(rows) == len(items), f"ocr {name}: {len(rows)} item_data rows for "
                    f"{len(items)} items")
            grays = [page_of[str(paths[0].parent / f)] for _, f in items]
            t0 = time.perf_counter()
            want = []
            for lo in range(0, len(grays), 16):  # the job's windows of the registry's 16
                want += impl.read_arrays(grays[lo : lo + 16])
            direct_s = time.perf_counter() - t0
            n_lines = sum(lines_of[str(paths[0].parent / f)] for _, f in items)
            for (item, _), out in zip(items, want):
                placeholder, text, conf = rows[item]
                if out["text"]:
                    require(not placeholder and text == out["text"] and abs(conf - out["confidence"])
                            <= 1e-6, f"ocr {name}: item {item}'s text differs from read_arrays")
                else:
                    require(placeholder and text is None, f"ocr {name}: item {item} empty")
            texts[name] = {item: out["text"] for (item, _), out in zip(items, want)}
            # The job's B3 launches: each slice of at most 16 strips a window
            # runs the trunk's layers once, after the prewarm's buckets.
            window_lines = [sum(lines_of[str(paths[0].parent / f)] for _, f in items[lo : lo + 16])
                            for lo in range(0, len(items), 16)]
            layers = impl.cfg.layers
            expected[name] = layers * (len(impl.batch_ladder) + sum(-(-n // 16) for n in window_lines))
            rec[name] = {"items": len(items), "lines": n_lines, "direct_read_s": direct_s,
                         "lines_per_s_direct": n_lines / direct_s,
                         "text_rows": sum(1 for t in texts[name].values() if t),
                         "chars_a_page": [min(map(len, texts[name].values())),
                                          float(np.mean([len(t) for t in texts[name].values()])),
                                          max(map(len, texts[name].values()))]}
        t_search = time.perf_counter()
        db, _, index = sides["ocr"]
        card = Executor(db, index, manager=manager, device=str(dev))
        cpu = Executor(db, index, manager=manager, device="cpu")
        rng = np.random.default_rng(SEED + 141)
        items = sorted(i for i, t in texts["ocr"].items() if len(t) >= 5)
        require(len(items) >= OCR_QUERIES, f"ocr search: {len(items)} items have a text")
        picks = [int(i) for i in np.linspace(0, len(items) - 1, OCR_QUERIES)]
        sizes, page_ms = [], []
        for pick in picks:
            item, text = items[pick], texts["ocr"][items[pick]]
            # A seeded 5-character window of the text, at least 3 of them not
            # blank (random weights read punctuation and blanks), as one FTS5
            # phrase: the trigram index matches it as a substring, any case,
            # blanks and newlines included.
            starts = [i for i in range(len(text) - 4)
                      if sum(not ch.isspace() for ch in text[i : i + 5]) >= 3]
            require(starts, f"ocr search: item {item}'s text {text[:40]!r} has no window")
            sub = text[starts[int(rng.integers(len(starts)))]:][:5]
            phrase = '"' + sub.replace('"', '""') + '"'
            payload = {"query": {"match_text": {"match": phrase}}, "page_size": OCR_PAGES}
            t0 = time.perf_counter()
            got = card.execute(pql.PqlQuery.from_json(payload))
            page_ms.append(1e3 * (time.perf_counter() - t0))
            want = cpu.execute(pql.PqlQuery.from_json(payload))
            found = [r["item_id"] for r in got.results]
            holders = {i for i, t in texts["ocr"].items() if sub.lower() in t.lower()}
            require(item in found and set(found) == holders,
                    f"ocr search: match_text {sub!r} found {len(found)} items, {len(holders)} "
                    f"hold it, item {item} among them: {item in found}")
            require(same_pages(got, want), f"ocr search: {sub!r} differs on the CPU")
            sizes.append(len(found))
        rec["expected_b3_launches"] = sum(expected.values())
        rec["search_s"] = time.perf_counter() - t_search
        rec["search"] = {"match_text_queries": len(sizes), "match_text_items": sizes,
                         "match_text_ms": [min(page_ms), float(np.median(page_ms)), max(page_ms)],
                         "card_equals_cpu": True}
        # One window of 16 pages split (host clock around synchronised parts,
        # the second pass kept): segmentation and strip prep on the host, the
        # copy to the card, the encoder, the head and argmax (and the one copy
        # back), the collapse; for the attention reader the decode, its steps
        # counted; and the card's busy share over the whole window.
        window = pages[:16]
        t_split = time.perf_counter()
        for name, model in (("ocr", OCR_MODEL), ("ocr_attn", OCR_ATTN_MODEL)):
            impl = manager._models[model].model
            steps = [0]
            step = whisper._decode_step

            def counted(*a, **k):
                steps[0] += 1
                return step(*a, **k)

            for _ in range(2):
                t = [time.perf_counter()]
                strips = [ocr.prepare_strip(g, box, impl.cfg) for g in window
                          for box in ocr.segment_lines(g)]
                t.append(time.perf_counter())
                xs = [torch.from_numpy(np.stack(strips[lo : lo + 16])).to(dev)
                      for lo in range(0, len(strips), 16)]
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                with torch.inference_mode():
                    feats = [ocr.encode_strips(impl.params, impl.cfg, x) for x in xs]
                    torch.cuda.synchronize()
                    t.append(time.perf_counter())
                    steps[0] = 0
                    if name == "ocr":
                        outs = [ocr.recognize(impl.params, impl.cfg, x) for x in xs]
                        host = [torch.cat([i.float(), c[:, None]], 1).cpu().numpy() for i, c in outs]
                    else:
                        whisper._decode_step = counted
                        try:
                            outs = [ocr.attn_read(impl.params, impl.attn_cfg, x) for x in xs]
                            host = [torch.cat([a.float(), b.float()[:, None], c[:, None]], 1)
                                    .cpu().numpy() for a, b, c in outs]
                        finally:
                            whisper._decode_step = step
                    t.append(time.perf_counter())
                for h in host:
                    for row in h:
                        if name == "ocr":
                            ocr.ctc_collapse(row[:-1].astype(np.int64), impl.cfg.charset)
                        else:
                            ocr.attn_collapse(row[:-2].astype(np.int64), int(row[-2]),
                                              impl.cfg.charset)
                t.append(time.perf_counter())
            # The busy share over one page of at most 16 lines (one slice):
            # the profiler's record of a whole window of the attention reader
            # (about 1,600 decode steps) takes minutes to read back.
            page = next(g for g, c in zip(pages, counts) if c <= 16)
            t_profile = time.perf_counter()
            wall_w, busy = busy_share(torch, lambda: impl.read_arrays([page]))
            t_profile = time.perf_counter() - t_profile
            split = dict(zip(("segment_and_prep", "h2d", "encode",
                              "head_argmax_and_copy" if name == "ocr" else "decode_and_copy",
                              "collapse"), (1e3 * (b - a) for a, b in zip(t, t[1:]))))
            rec[name].update({"window_pages": len(window), "window_lines": len(strips),
                              "window_slices": len(xs), "window_split_ms": split,
                              "profiled_page_lines": len(ocr.segment_lines(page)),
                              "profiled_page_s": wall_w, "profile_and_read_back_s": t_profile,
                              "device_busy_share_page": busy, "device_idle_share_page": 1 - busy})
            if name == "ocr_attn":
                rec[name].update({"decode_steps": steps[0],
                                  "decode_ms_per_step": split["decode_and_copy"] / steps[0]})
        rec["split_s"] = time.perf_counter() - t_split
    return rec


def ocr_pair_path(torch, dev, smi, pages) -> dict:
    """Phase 14(d): the lines of ``pages`` through both readers on the card
    and on the CPU (the card impls' weights copied: CUDA and CPU generators
    draw different random weights): strip features and CTC logits at cosine
    ≥ 0.999 a token, the CTC ids equal wherever the card's top-2 margin
    exceeds twice the logits' max abs error; the attention reader's decoder
    steps teacher-forced on the card's tokens at cosine ≥ 0.999 a position
    with the argmax rule, and the CPU's free-running tokens equal to the
    card's up to the first narrow margin."""
    from panoptikon_tpu_torch.models import impls, ocr

    out = {"part": "d_card_equals_cpu", "card": smi, "pages": len(pages)}
    for recognizer in ("ctc", "attn"):
        arch = "attn-base" if recognizer == "attn" else "crnn-base"
        card = impls.OcrImpl(arch, recognizer=recognizer)
        card.load()
        cpu = impls.OcrImpl(arch, recognizer=recognizer, device="cpu")
        cpu.params = _tree_to(card.params, "cpu")
        cfg = card.cfg
        strips = np.stack([ocr.prepare_strip(g, box, cfg) for g in pages
                           for box in ocr.segment_lines(g)])
        x = torch.from_numpy(strips)
        rec = {"lines": len(strips)}
        with torch.inference_mode():
            feats = {}
            for name, impl in (("card", card), ("cpu", cpu)):
                t0 = time.perf_counter()
                feats[name] = ocr.encode_strips(impl.params, cfg, x.to(impl.device))
                torch.cuda.synchronize()
                rec[f"{name}_encode_s"] = time.perf_counter() - t0
            f_card, f_cpu = (feats[k].float().cpu().numpy() for k in ("card", "cpu"))
            cos = cosines(f_card.reshape(-1, cfg.width), f_cpu.reshape(-1, cfg.width))
            require(float(cos.min()) >= 0.999, f"ocr pair {recognizer}: features min cosine "
                    f"{cos.min()}")
            rec["features_min_cosine"] = float(cos.min())
            if recognizer == "ctc":
                lg = {name: ocr.logits(impl.params, cfg, x.to(impl.device)).cpu().numpy()
                      for name, impl in (("card", card), ("cpu", cpu))}
                got, want = lg["cpu"], lg["card"]
                cos = cosines(got.reshape(-1, cfg.classes), want.reshape(-1, cfg.classes))
                require(float(cos.min()) >= 0.999, f"ocr pair: CTC logits min cosine {cos.min()}")
                err = float(np.abs(got - want).max())
                top2 = np.sort(want, axis=-1)[..., -2:]
                decided = top2[..., 1] - top2[..., 0] > 2 * err
                ids = ocr.recognize(card.params, cfg, x.to(dev))[0].cpu().numpy()
                require((ids == want.argmax(-1)).all() and bool(
                    (got.argmax(-1) == ids)[decided].all()),
                    "ocr pair: CTC ids differ where the margin is wide")
                rec.update({"logits_min_cosine": float(cos.min()), "logits_max_abs_err": err,
                            "columns_decided": int(decided.sum()), "columns": int(decided.size)})
            else:
                acfg = card.attn_cfg
                dcfg = acfg.decoder_cfg()
                tokens = ocr.attn_read(card.params, acfg, x.to(dev))[0].cpu()
                logits = {name: _teacher_forced(torch, impl.params, dcfg, feats[name],
                                                tokens.to(impl.device))
                          for name, impl in (("card", card), ("cpu", cpu))}
                got, want = logits["cpu"], logits["card"]
                cos = cosines(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]))
                require(float(cos.min()) >= 0.999,
                        f"ocr pair: teacher-forced logits min cosine {cos.min()}")
                err = float(np.abs(got - want).max())
                top2 = np.sort(want, axis=-1)[..., -2:]
                margin = top2[..., 1] - top2[..., 0]
                decided = margin > 2 * err
                require(bool((got.argmax(-1) == want.argmax(-1))[decided].all()),
                        "ocr pair: the decoder's argmax differs where the margin is wide")
                t0 = time.perf_counter()
                cpu_tokens = ocr.attn_read(cpu.params, acfg, x)[0]
                rec["cpu_decode_s"] = time.perf_counter() - t0
                splits = []
                for j in range(len(strips)):
                    # Step i decides token i + 1; past a row's EOT nothing is
                    # decided (the row latches EOT, or stays 0 once every row
                    # is done, which may differ between the two decodes).
                    ends = np.flatnonzero(tokens[j].numpy() == acfg.eot)
                    end = int(ends[0]) if ends.size else acfg.max_chars - 1
                    low = np.flatnonzero(margin[j, :end] <= 2 * err)
                    first = int(low[0]) if low.size else end
                    require(torch.equal(cpu_tokens[j, : first + 1], tokens[j, : first + 1]),
                            f"ocr pair: line {j}'s free-running tokens split before {first}")
                    splits.append(first if low.size else None)
                rec.update({"teacher_forced_min_cosine": float(cos.min()),
                            "logits_max_abs_err": err, "positions_decided": int(decided.sum()),
                            "positions": int(decided.size),
                            "first_low_margin_position": [min(s for s in splits if s is not None)
                                                          if any(s is not None for s in splits)
                                                          else None,
                                                          sum(s is None for s in splits)]})
        out[recognizer] = rec
        del card, cpu
    return out


def ocr_kernels(torch, dev, smi, counters) -> dict:
    """Phase 14(e): B3 off the main path's counts, against mha_plain within
    2e-2 and timed kernel/plain/plain/kernel beside SDPA and the bound: at
    the OCR trunk's attention (OCR_ATTN_SHAPE) on the tensor cores, and past
    D 128 (WIDE_HEAD_DIMS × WIDE_ATTN_CASES, the captioner decoder's rows)
    on the CUDA-core route's wide instantiation."""
    from panoptikon_tpu_torch.ops import vit_attention

    gen = torch.Generator(device=dev).manual_seed(SEED + 142)
    cases = {"ocr_trunk": (*OCR_ATTN_SHAPE[:2], *OCR_ATTN_SHAPE[1:], False, False)}
    for d in WIDE_HEAD_DIMS:
        for mode, (b, nq, nkv, h, causal, masked) in WIDE_ATTN_CASES.items():
            cases[f"d{d}_{mode}"] = (b, nq, nkv, h, d, causal, masked)
    shapes = {}
    with not_counted(counters):
        for name, (b, nq, nkv, h, d, causal, masked) in cases.items():
            q, k, v = (torch.randn((b, n, h, d), generator=gen, device=dev).to(torch.bfloat16)
                       for n in (nq, nkv, nkv))
            mask = None
            if masked:
                mask = torch.rand((b, nkv), generator=gen, device=dev) < 0.7
                mask[0] = False  # a fully masked row
            path = vit_attention.route(q.dtype, d)
            require(path == ("tensor_core" if name == "ocr_trunk" else "cuda_core"),
                    f"mha {name}: route {path}")
            before = vit_attention.mha.routes[path]
            got = vit_attention.mha(q, k, v, causal=causal, key_mask=mask)
            require(vit_attention.mha.routes[path] == before + 1, f"mha {name}: not on {path}")
            want = vit_attention.mha_plain(q, k, v, causal=causal, key_mask=mask)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            require(torch.isfinite(got.float()).all().item() and err <= 2e-2,
                    f"mha {name}: max abs diff {err} > 2e-2")
            ms, plain_ms = paired_ms(
                torch, lambda: vit_attention.mha(q, k, v, causal=causal, key_mask=mask),
                lambda: vit_attention.mha_plain(q, k, v, causal=causal, key_mask=mask), reps=10)
            shapes[name] = {"shape": [b, nq, nkv, h, d], "causal": causal, "key_masked": masked,
                            "route": path, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            **attention_roofline(q, k, v, got, causal, mask),
                            "library_ms": cuda_ms(torch, lambda: sdpa(torch, q, k, v, causal, mask),
                                                  reps=10)}
    return {"part": "e_b3", "card": smi, "shapes": shapes}


def cosines(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from panoptikon_tpu_torch import _build
    from panoptikon_tpu_torch.device import device
    from panoptikon_tpu_torch.index import VectorIndex
    from panoptikon_tpu_torch.index.device_index import DeviceIndex
    from panoptikon_tpu_torch.models import clip
    from panoptikon_tpu_torch.ops import codec, exact, int8_scan, ln_quant, scoring, vit_attention

    dev = device("cuda")

    # 1. Environment.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    # The DB of phase 9(c) needs SQLite's FTS5: reported here, required there.
    fts5 = "ENABLE_FTS5" in {row[0] for row in sqlite3.connect(":memory:").execute(
        "PRAGMA compile_options")}
    emit({"phase": "env", "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc, "triton": triton_version, "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "sqlite": sqlite3.sqlite_version,
          "sqlite_fts5": fts5})

    # 2. Build: one nvcc per source, all started together.
    def build_one(name):
        t0 = time.perf_counter()
        _build.build(name)
        return name, {
            "seconds": time.perf_counter() - t0,
            "ptxas": [ln.strip() for ln in _build.ptxas_report(name).splitlines()
                      if "registers" in ln or "spill" in ln],
        }

    def build_host_codec():
        t0 = time.perf_counter()
        _build.build_host("host_codec")
        return "host_codec", {"seconds": time.perf_counter() - t0,
                              "library": _build.host_library_path("host_codec").name}

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        host = pool.submit(build_host_codec)
        build = dict(pool.map(build_one, ("int8_scan", "attention", "ln_quant")))
        build.update([host.result()])
    build_s = time.perf_counter() - t0
    # The native host codec is required here: the index builds of phases 4
    # and 11 quantize through it.
    require(codec.native_available(), "host_codec: the native host codec did not build or load")
    # Both scans' dots on the tensor cores: each form of B1's and B2's
    # kernels holds IMMA (mma.sync) or IGMMA (wgmma) instructions, and none
    # holds IDP4A (the CUDA cores' four-way int8 dot).
    scan_ops = {}
    for function in _build.sass("int8_scan").split("Function : ")[1:]:
        name = function.split(None, 1)[0]
        for kernel in ("int8_topk_kernel", "int8_topk_v2_kernel"):
            if kernel + "I" in name:
                form = name[name.index(kernel) + len(kernel):].split("EEv")[0]
                scan_ops.setdefault(kernel, {})[form] = {
                    "tensor_core": len(re.findall(r"\bIG?MMA\.", function)),
                    "idp4a": len(re.findall(r"\bIDP4A\b", function))}
    for kernel, forms in scan_ops.items():
        require(any(f.startswith("ILb0") for f in forms) and any(f.startswith("ILb1") for f in forms),
                f"{kernel}: a cosine and an L2 form, found {sorted(forms)}")
        require(all(ops["tensor_core"] > 0 and ops["idp4a"] == 0 for ops in forms.values()),
                f"{kernel}: tensor-core and IDP4A instructions by form {forms}")
    require(set(scan_ops) == {"int8_topk_kernel", "int8_topk_v2_kernel"},
            f"scan kernels found in the build: {sorted(scan_ops)}")
    emit({"phase": "build", "wall_seconds": build_s, "scan_kernel_instructions": scan_ops, **build})

    # 3. Kernels against their plain versions.
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    attn_err = {}
    attn_inputs = {}
    for name, (b, nq, nkv, h, d, causal, masked) in ATTN_CASES.items():
        q, k, v = randn(b, nq, h, d), randn(b, nkv, h, d), randn(b, nkv, h, d)
        mask = None
        if masked:
            mask = torch.rand((b, nkv), generator=gen, device=dev) < 0.7
            mask[0] = False  # a fully masked row
        got = vit_attention.mha(q, k, v, causal=causal, key_mask=mask)
        want = vit_attention.mha_plain(q, k, v, causal=causal, key_mask=mask)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        require(torch.isfinite(got.float()).all().item(), f"mha {name}: non-finite output")
        require(err <= 2e-2, f"mha {name}: max abs diff {err} > 2e-2")
        attn_err[name] = err
        attn_inputs[name] = (q, k, v, causal, mask)
    # B3 at the text encoders' shapes: q, k, v the views of one fused qkv (the
    # layout the encoder hands the kernel), a key mask of seeded ragged
    # valid lengths; each launch on the tensor cores.
    for name, (b, n, h, d) in TEXT_ATTN_CASES.items():
        q, k, v = (t.view(b, n, h, d) for t in randn(b, n, 3 * h * d).split(h * d, dim=-1))
        mask = torch.arange(n, device=dev)[None, :] < torch.randint(
            1, n + 1, (b, 1), generator=gen, device=dev)
        tc = vit_attention.mha.routes["tensor_core"]
        got = vit_attention.mha(q, k, v, key_mask=mask)
        require(vit_attention.mha.routes["tensor_core"] == tc + 1, f"mha {name}: not on the tensor cores")
        want = vit_attention.mha_plain(q, k, v, key_mask=mask)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        require(torch.isfinite(got.float()).all().item(), f"mha {name}: non-finite output")
        require(err <= 2e-2, f"mha {name}: max abs diff {err} > 2e-2")
        attn_err[name] = err
        attn_inputs[name] = (q, k, v, False, mask)
    # The tensor-core kernel's p = e / s (one correction of e·(1/s)) against a
    # correctly rounded division, for every float e in [0, 1], at row sums
    # 1 to 4,096: powers of two, the floats under them, seeded values.
    rng = np.random.default_rng(SEED + 5)
    under = np.nextafter(np.float32(2.0) ** np.arange(1, 13, dtype=np.float32), np.float32(0))
    divisors = np.concatenate([[1.0, 3.0, 257.0, 1500.0], 2.0 ** np.arange(1, 13), under,
                               np.exp(rng.uniform(0, np.log(4096), 32))])
    div_counts = vit_attention.check_div_rn(torch.from_numpy(divisors.astype(np.float32)).to(dev))
    div_mismatches = int(div_counts.sum().item())
    require(div_mismatches == 0, f"div_rn differs from a correctly rounded division: {div_counts}")
    # ln_quant's code y / sx by one correction of y·(1/sx), against a correctly
    # rounded division, for every float y, at the phase's absmax and others.
    absmax = np.concatenate([[4.2, 15.875, 1.0, 127.0, 1e-12], np.exp(rng.uniform(-7, 7, 8))])
    quant_counts = ln_quant.check_quant_code(torch.from_numpy(absmax.astype(np.float32)).to(dev))
    quant_mismatches = int(quant_counts.sum().item())
    require(quant_mismatches == 0, f"ln_quant codes differ from a correctly rounded division: "
                                   f"{quant_counts}")
    # B2's branch-free reciprocal square root against __frsqrt_rn (B1's), for
    # every positive normal float.
    rsqrt_mismatches = int8_scan.check_rsqrt_rn(dev)
    require(rsqrt_mismatches == 0, f"B2's rsqrt_rn differs from __frsqrt_rn at {rsqrt_mismatches}")
    # Below D = 32, p stays f32 in the kernel as in its plain version.
    q, k, v, _, _ = attn_inputs["head_dim_16"]
    d16_identical = float((vit_attention.mha(q, k, v) == vit_attention.mha_plain(q, k, v))
                          .float().mean().item())
    require(d16_identical >= 0.995, f"mha D=16: only {d16_identical} of outputs identical")

    # mha_qkv at the shapes of the int8 embed (and ViT-H-14-378's N = 730, D = 80).
    qkv_err, qkv_inputs = {}, {}
    for name, (b, n, h, d, causal, q8) in QKV_CASES.items():
        qkv = randn(b, n, 3 * h * d)
        scale_t = torch.tensor(3.0, device=dev) if q8 else None
        got = vit_attention.mha_qkv(qkv, heads=h, causal=causal, out_scale=scale_t)
        want = vit_attention.mha_qkv_plain(qkv, heads=h, causal=causal, out_scale=scale_t)
        torch.cuda.synchronize()
        require(got.shape == want.shape == (b, n, h * d) and got.dtype == want.dtype,
                f"mha_qkv {name}: shape or dtype")
        if q8:
            qkv_err[name] = require_codes(torch, got, want, f"mha_qkv {name}")
        else:
            err = (got.float() - want.float()).abs().max().item()
            require(err <= 2e-2, f"mha_qkv {name}: max abs diff {err} > 2e-2")
            qkv_err[name] = err
        qkv_inputs[name] = (qkv, h, causal, scale_t)

    # ln_quant at the embed's two widths and a ragged shape.
    ln_err, ln_inputs = {}, {}
    for name, (r, w) in LN_CASES.items():
        x = randn(r, w) * 3
        g, b_ = randn(w, dtype=torch.float32), randn(w, dtype=torch.float32)
        s_t = torch.tensor(4.2, device=dev)
        got = ln_quant.ln_quant_2d(x, g, b_, s_t)
        want = ln_quant.ln_quant_plain(x, g, b_, s_t)
        torch.cuda.synchronize()
        ln_err[name] = require_codes(torch, got, want, f"ln_quant {name}")
        ln_inputs[name] = (x, g, b_, s_t)

    # The int8 GEMM of the embed (torch._int_mm) against an exact f64 GEMM.
    m8, k8, n8 = INT_MM_SHAPE
    a8 = torch.randint(-127, 128, (m8, k8), generator=gen, device=dev, dtype=torch.int8)
    w8 = clip._quantize_weight(randn(k8, n8, dtype=torch.float32))["q"]
    int_mm = clip._int_mm(a8, w8)
    exact_mm = (a8.double() @ w8.double()).to(torch.int32)
    torch.cuda.synchronize()
    require(torch.equal(int_mm, exact_mm), "torch._int_mm differs from the exact GEMM")
    del int_mm, exact_mm

    n_scan, q_scan, k_scan = N_SCAN, Q_SCAN, OVERSAMPLE * K
    x = torch.randn((n_scan, DIM), generator=gen, device=dev)
    x[list(PLANTED)] = x[5].clone()  # planted equal rows, in different tiles
    x = x / torch.linalg.norm(x, dim=1, keepdim=True)
    qv = torch.randn((q_scan, DIM), generator=gen, device=dev)
    qv[0] = x[5]
    qv = qv / torch.linalg.norm(qv, dim=1, keepdim=True)
    scale = codec.scale_from_absmax(x.abs().max().item())
    s_codes, s_q = codec.quantize_int8(x, scale), codec.quantize_int8(qv, scale)
    s_sumsq = scoring.row_sumsq(s_codes)
    s_valid = torch.rand(n_scan, generator=gen, device=dev) > 0.05
    s_valid[[5, *PLANTED]] = True
    scan_args = (s_codes, s_sumsq, s_valid, s_q)
    gv, gi, gok = int8_scan.int8_topk(*scan_args, k=k_scan)
    pv, pi, pok = int8_scan.int8_topk_plain(*scan_args, k=k_scan)
    torch.cuda.synchronize()
    scan_err = (gv - pv).abs().max().item()
    require(torch.equal(gi, pi) and torch.equal(gok, pok), "int8_topk: ids differ from plain")
    require(scan_err <= 1e-6, f"int8_topk: max abs dist diff {scan_err} > 1e-6")
    require(gi[0, :4].tolist() == [5, *PLANTED], "int8_topk: planted tie order")
    require(bool(s_valid[gi].all().item()), "int8_topk: an invalid row was returned")
    gv, gi, gok = int8_scan.int8_topk(*scan_args, k=k_scan, distance="l2", scale=scale)
    pv, pi, pok = int8_scan.int8_topk_plain(*scan_args, k=k_scan, distance="l2", scale=scale)
    torch.cuda.synchronize()
    scan_l2_err = (gv - pv).abs().max().item()
    require(torch.equal(gi, pi) and torch.equal(gok, pok), "int8_topk l2: ids differ from plain")
    require(scan_l2_err <= 1e-6, f"int8_topk l2: max abs dist diff {scan_l2_err} > 1e-6")
    require(gi[0, :4].tolist() == [5, *PLANTED], "int8_topk l2: planted tie order")
    scan_bound = scan_roofline(scan_args, k_scan)
    # B1 at k = 1,024 (16 queries a block, lists of 1,024 keys), cosine and
    # L2, and at Q = 1 (one query block: the strips alone fill the card).
    b1_cases = {
        "k1024_cosine": (scan_args, {"k": int8_scan.MAX_K}),
        "k1024_l2": (scan_args, {"k": int8_scan.MAX_K, "distance": "l2", "scale": scale}),
        "q1_k80": ((s_codes, s_sumsq, s_valid, s_q[:1]), {"k": k_scan}),
    }
    b1_err = {}
    for name, (args, kw) in b1_cases.items():
        gv, gi, gok = int8_scan.int8_topk(*args, **kw)
        pv, pi, pok = int8_scan.int8_topk_plain(*args, **kw)
        torch.cuda.synchronize()
        require(torch.equal(gi, pi) and torch.equal(gok, pok), f"int8_topk {name}: ids differ")
        b1_err[name] = (gv - pv).abs().max().item()
        require(b1_err[name] <= 1e-6, f"int8_topk {name}: max abs dist diff {b1_err[name]}")
        require(gi[0, :4].tolist() == [5, *PLANTED], f"int8_topk {name}: planted tie order")

    # B2 at Q = 1,024 on the same corpus, cosine and L2, and on a ragged
    # corpus (N_RAGGED rows, its second tile invalid, so that rounds at +inf
    # give sentinel rows and k = 80 exceeds the 5 tiles' 40 candidates).
    qv2 = torch.randn((Q_SCAN_V2, DIM), generator=gen, device=dev)
    qv2[0] = x[5]
    qv2 = qv2 / torch.linalg.norm(qv2, dim=1, keepdim=True)
    v2_args = (s_codes, s_sumsq, s_valid, codec.quantize_int8(qv2, scale))
    r_valid = s_valid[:N_RAGGED].clone()
    r_valid[2048:4096] = False
    v2_cases = {
        "cosine": (v2_args, {}),
        "l2": (v2_args, {"distance": "l2", "scale": scale}),
        "ragged": ((s_codes[:N_RAGGED], s_sumsq[:N_RAGGED], r_valid, v2_args[3]), {}),
    }
    v2_err = {}
    for name, (args, kw) in v2_cases.items():
        gv, gi, gok = int8_scan.int8_topk_v2(*args, k=k_scan, **kw)
        pv, pi, pok = int8_scan.int8_topk_v2_plain(*args, k=k_scan, **kw)
        torch.cuda.synchronize()
        require(torch.equal(gi, pi) and torch.equal(gok, pok), f"int8_topk_v2 {name}: ids differ")
        v2_err[name] = (gv - pv)[gok].abs().max().item()
        require(v2_err[name] <= 1e-6, f"int8_topk_v2 {name}: max abs dist diff {v2_err[name]}")
        require(bool((gi[~gok] == int8_scan.SENTINEL_ROW).all().item()),
                f"int8_topk_v2 {name}: a candidate at +inf without the sentinel row")
        require(bool(args[2][gi[gok]].all().item()), f"int8_topk_v2 {name}: an invalid row won")
        if name != "ragged":
            require(gi[0, :4].tolist() == [5, *PLANTED], f"int8_topk_v2 {name}: planted tie order")
        if name == "cosine":
            v2_bound = scan_roofline(args, gi.shape[1])
    require(gi.shape[1] == 40 and int((~gok).sum().item()) == 8 * Q_SCAN_V2,
            "int8_topk_v2 ragged: 40 candidates, the invalid tile's 8 at +inf")

    attn_ms = {}
    for name, (q, k, v, causal, mask) in attn_inputs.items():
        attn_ms[name] = paired_ms(
            torch, lambda: vit_attention.mha(q, k, v, causal=causal, key_mask=mask),
            lambda: vit_attention.mha_plain(q, k, v, causal=causal, key_mask=mask),
            reps=5 if q.shape[0] * q.shape[1] * k.shape[1] > 2**22 else 20)
    # The text encoder hands B3 the views of its fused qkv (one row stride).
    # In turns against the way out it did not take: the three heads copied
    # apart, then the contiguous kernel; and that kernel alone.
    text_layout_ms = {}
    for name in TEXT_ATTN_CASES:
        q, k, v, _, mask = attn_inputs[name]
        contig = [t.contiguous() for t in (q, k, v)]
        strided_ms, copied_ms = paired_ms(
            torch, lambda: vit_attention.mha(q, k, v, key_mask=mask),
            lambda: vit_attention.mha(*(t.contiguous() for t in (q, k, v)), key_mask=mask), reps=10)
        text_layout_ms[name] = {
            "strided_ms": strided_ms, "copies_then_contiguous_ms": copied_ms,
            "contiguous_alone_ms": cuda_ms(torch, lambda: vit_attention.mha(*contig, key_mask=mask),
                                           reps=10)}
    del contig
    scan_ms, scan_plain_ms = paired_ms(
        torch, lambda: int8_scan.int8_topk(*scan_args, k=k_scan),
        lambda: int8_scan.int8_topk_plain(*scan_args, k=k_scan), reps=10)
    scan_l2_ms, scan_l2_plain_ms = paired_ms(
        torch, lambda: int8_scan.int8_topk(*scan_args, k=k_scan, distance="l2", scale=scale),
        lambda: int8_scan.int8_topk_plain(*scan_args, k=k_scan, distance="l2", scale=scale),
        reps=10)
    b1_ms = {name: paired_ms(torch, lambda: int8_scan.int8_topk(*args, **kw),
                             lambda: int8_scan.int8_topk_plain(*args, **kw), reps=10)
             for name, (args, kw) in b1_cases.items()}
    b1_bounds = {name: scan_roofline(args, kw["k"]) for name, (args, kw) in b1_cases.items()}
    b1_gemm_ms = {"q64": gemm_only_ms(torch, scan_args), "q1": gemm_only_ms(torch, b1_cases["q1_k80"][0])}
    v2_ms = {name: paired_ms(torch, lambda: int8_scan.int8_topk_v2(*args, k=k_scan, **kw),
                             lambda: int8_scan.int8_topk_v2_plain(*args, k=k_scan, **kw), reps=5)
             for name, (args, kw) in v2_cases.items() if name != "ragged"}
    qkv_ms = {}
    for name, (qkv, h, causal, scale_t) in qkv_inputs.items():
        qkv_ms[name] = paired_ms(
            torch, lambda: vit_attention.mha_qkv(qkv, heads=h, causal=causal, out_scale=scale_t),
            lambda: vit_attention.mha_qkv_plain(qkv, heads=h, causal=causal, out_scale=scale_t),
            reps=5)
    ln_ms = {name: paired_ms(torch, lambda: ln_quant.ln_quant_2d(*args),
                             lambda: ln_quant.ln_quant_plain(*args))
             for name, args in ln_inputs.items()}
    int_mm_ms, exact_mm_ms = paired_ms(
        torch, lambda: clip._int_mm(a8, w8), lambda: (a8.double() @ w8.double()).to(torch.int32),
        reps=5)
    # The layout rule of clip._int_mm: the same codes with B row-major.
    w8_rows = w8.contiguous()
    require(torch.equal(torch._int_mm(a8, w8_rows), clip._int_mm(a8, w8)),
            "torch._int_mm: row-major B differs from column-major B")
    int_mm_ms_b_col, int_mm_ms_b_row = paired_ms(
        torch, lambda: torch._int_mm(a8, w8), lambda: torch._int_mm(a8, w8_rows), reps=5)

    # The library yardstick and the bound of every attention case: mha's,
    # and mha_qkv's with q, k, v as views of the unsplit qkv.
    attn_timed = dict(attn_inputs)
    for name, (qkv, h, causal, scale_t) in qkv_inputs.items():
        b, n = qkv.shape[:2]
        parts = qkv.view(b, n, 3, h, -1).unbind(2)
        attn_timed["qkv_" + name] = (*parts, causal, None, scale_t)
    library_ms, sdpa_err, bounds, attn_routes = {}, {}, {}, {}
    for name, (q, k, v, causal, mask, *q8) in attn_timed.items():
        int8_out = bool(q8 and q8[0] is not None)
        out = torch.empty((*q.shape[:3], v.shape[3]), device=dev,
                          dtype=torch.int8 if int8_out else q.dtype)
        bounds[name] = attention_roofline(q, k, v, out, causal, mask)
        attn_routes[name] = vit_attention.route(q.dtype, q.shape[3])
        if not int8_out:  # no single library call quantizes the output
            want = vit_attention.mha_plain(q, k, v, causal=causal, key_mask=mask)
            got = sdpa(torch, q, k, v, causal, mask)
            sdpa_err[name] = (got.float() - want.float()).abs().max().item()
            library_ms[name] = cuda_ms(torch, lambda: sdpa(torch, q, k, v, causal, mask), reps=5)
    for name, (x_ln, g, b_, s_t) in ln_inputs.items():
        r, w = x_ln.shape
        bounds["ln_" + name] = roofline(LN_OPS_PER_ELEMENT * r * w, "f32",
                                        nbytes(x_ln, g, b_, s_t) + r * w)
    bounds["int8_topk_cosine"] = scan_bound
    bounds["int8_topk_v2_cosine"] = v2_bound
    emit({"phase": "kernels", "card": smi, "mha_max_abs_err": attn_err,
          "mha_head_dim_16_identical_share": d16_identical,
          "div_rn_divisors": len(divisors), "div_rn_mismatches_in_0_1": div_mismatches,
          "ln_quant_code_absmax_values": len(absmax),
          "ln_quant_code_mismatches_all_floats": quant_mismatches,
          "int8_topk_v2_rsqrt_mismatches_all_normal_floats": rsqrt_mismatches,
          "mha_qkv_max_err": qkv_err, "ln_quant_max_code_diff": ln_err,
          "int8_topk_max_abs_err": scan_err, "int8_topk_l2_max_abs_err": scan_l2_err,
          "attention_routes": attn_routes, "attention_tc_query_rows": vit_attention.TC_QUERY_ROWS,
          "mha_ms": {n: t[0] for n, t in attn_ms.items()},
          "mha_plain_ms": {n: t[1] for n, t in attn_ms.items()},
          "mha_text_layout_ms": text_layout_ms,
          "mha_qkv_ms": {n: t[0] for n, t in qkv_ms.items()},
          "mha_qkv_plain_ms": {n: t[1] for n, t in qkv_ms.items()},
          "ln_quant_ms": {n: t[0] for n, t in ln_ms.items()},
          "ln_quant_plain_ms": {n: t[1] for n, t in ln_ms.items()},
          "int_mm_shape": INT_MM_SHAPE, "int_mm_ms": int_mm_ms, "exact_f64_gemm_ms": exact_mm_ms,
          "torch_int_mm_b_column_major_ms": int_mm_ms_b_col,
          "torch_int_mm_b_row_major_ms": int_mm_ms_b_row,
          "int8_topk_65536x512_q64_k80_ms": scan_ms,
          "int8_topk_65536x512_q64_k80_plain_ms": scan_plain_ms,
          "int8_topk_l2_65536x512_q64_k80_ms": scan_l2_ms,
          "int8_topk_l2_65536x512_q64_k80_plain_ms": scan_l2_plain_ms,
          "int8_topk_65536x512_max_abs_err": b1_err,
          "int8_topk_65536x512_ms": {n: t[0] for n, t in b1_ms.items()},
          "int8_topk_65536x512_plain_ms": {n: t[1] for n, t in b1_ms.items()},
          "int8_topk_65536x512_bounds": b1_bounds,
          "int8_topk_65536x512_gemm_only_ms": b1_gemm_ms,
          "int8_topk_v2_max_abs_err": v2_err,
          "int8_topk_v2_65536x512_q1024_k80_ms": {n: t[0] for n, t in v2_ms.items()},
          "int8_topk_v2_65536x512_q1024_k80_plain_ms": {n: t[1] for n, t in v2_ms.items()},
          "sdpa_library_ms": library_ms, "sdpa_max_abs_vs_plain": sdpa_err, "bounds": bounds})
    del x, qv, qv2, scan_args, v2_args, v2_cases, b1_cases, s_codes, attn_inputs, attn_timed
    del q, k, v, qkv_inputs, ln_inputs, a8, w8, w8_rows

    # 4. The ViT-B/32 search slice. Counters start at zero here.
    cfg = clip.CONFIGS["ViT-B-32"]
    params = clip.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dtype=torch.bfloat16)
    counters = (int8_scan.int8_topk, int8_scan.int8_topk_v2, vit_attention.mha,
                vit_attention.mha_qkv, ln_quant.ln_quant_2d)
    reset_counts(counters)

    img_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    embeds = []
    torch.cuda.synchronize()
    t_embed = 0.0
    for i in range(N_IMAGES // IMAGE_BATCH):
        images = torch.randn((IMAGE_BATCH, cfg.image_size, cfg.image_size, 3),
                             generator=img_gen, device=dev, dtype=torch.bfloat16)
        t0 = time.perf_counter()
        out = clip.embed_images(params, cfg, images)
        torch.cuda.synchronize()
        if i:  # the first batch pays for loading and warming up
            t_embed += time.perf_counter() - t0
        embeds.append(out)
    img_emb = torch.cat(embeds)
    require(tuple(img_emb.shape) == (N_IMAGES, cfg.embed_dim), "image embeddings shape")
    require(bool(torch.isfinite(img_emb).all().item()), "image embeddings finite")
    require(bool(((torch.linalg.norm(img_emb, dim=1) - 1).abs() < 1e-3).all().item()),
            "image embeddings unit norm")
    img_per_s = (N_IMAGES - IMAGE_BATCH) / t_embed

    # The host index build through the native codec, then through its NumPy
    # path on the same rows: codes equal bit for bit.
    img_np = img_emb.cpu().numpy()
    before = dict(codec.native_calls)
    index, scale, host_build_s = host_index_build(torch, dev, img_np)
    native_quant_calls = {k: codec.native_calls[k] - before[k] for k in before}
    require(codec.native_available() and native_quant_calls["quantize"] > 0,
            f"host index build: the native codec was not used {native_quant_calls}")
    with numpy_codec(codec):
        np_index, np_scale, host_build_numpy_s = host_index_build(torch, dev, img_np)
    snap_n, snap_p = index.snapshot("clip"), np_index.snapshot("clip")
    require(np_scale == scale and np.array_equal(snap_n.codes[:N_ROWS], snap_p.codes[:N_ROWS]),
            "host index build: native codes differ from the NumPy path's")
    del np_index, snap_p
    quant_s = {"native": [], "numpy": []}
    for path in ("native", "numpy", "numpy", "native"):
        index.drop_quant("clip")
        with numpy_codec(codec) if path == "numpy" else contextlib.nullcontext():
            t0 = time.perf_counter()
            require(index.build_quant("clip") == scale, "build_quant: the scale changed")
            quant_s[path].append(time.perf_counter() - t0)
    require(np.array_equal(index.snapshot("clip").codes[:N_ROWS], snap_n.codes[:N_ROWS]),
            "host index build: codes changed on a rebuild")
    del snap_n
    t0 = time.perf_counter()
    dindex = DeviceIndex(index, "clip", dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    require(dindex.size == N_ROWS, "index rows")

    rng = np.random.default_rng(SEED)
    ids = rng.integers(1, EOT, size=(N_TEXT, cfg.text_ctx))
    for r, e in enumerate(rng.integers(1, cfg.text_ctx, size=N_TEXT)):
        ids[r, e] = EOT
        ids[r, e + 1:] = 0
    token_ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
    txt_emb = clip.embed_texts(params, cfg, token_ids)
    require(bool(torch.isfinite(txt_emb).all().item()), "text embeddings finite")
    tv, ti, tok = dindex.search(txt_emb, K, oversample=OVERSAMPLE)

    gq = torch.randn((N_GAUSS, DIM), generator=torch.Generator(device=dev).manual_seed(SEED + 3),
                     device=dev)
    gq = gq / torch.linalg.norm(gq, dim=1, keepdim=True)
    sv, si, sok = dindex.search(gq, K, oversample=OVERSAMPLE)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    routes = read_routes(counters)

    # 5. Checks and times.
    require(launches["int8_topk"] > 0 and launches["mha"] > 0 and launches["int8_topk_v2"] == 0,
            f"kernel launches {launches}")
    require_tensor_cores(launches, routes, ("mha", "mha_qkv"), "search slice")
    for name, (rows, ok) in {"text": (ti, tok), "gaussian": (si, sok)}.items():
        require(bool(ok.all().item()), f"{name}: every top-{K} entry valid")
        require(bool(((rows >= 0) & (rows < dindex.size)).all().item()), f"{name}: rows in range")
        require(bool(dindex.row_valid[rows].all().item()), f"{name}: rows are valid rows")
    require(len(dindex.item_ids(ti, tok)) == N_TEXT, "item ids of text results")

    # The scan kernel against its plain version at the main path's shapes:
    # all k·oversample candidates, for both query sets and for one query
    # (the interactive search: one query block, 132 strips).
    plain_cand = {}
    scan_1m_err = 0.0
    for name, q_f32 in {"text": txt_emb, "gaussian": gq, "gaussian_q1": gq[:1]}.items():
        args = (dindex.codes, dindex.sumsq, dindex.row_valid, codec.quantize_int8(q_f32, scale))
        gv, gi, gok = int8_scan.int8_topk(*args, k=K * OVERSAMPLE)
        pv, pi, pok = int8_scan.int8_topk_plain(*args, k=K * OVERSAMPLE)
        torch.cuda.synchronize()
        err = (gv - pv).abs().max().item()
        require(torch.equal(gi, pi) and torch.equal(gok, pok),
                f"int8_topk at {N_ROWS} rows ({name}): ids differ from plain")
        require(err <= 1e-6, f"int8_topk at {N_ROWS} rows ({name}): max abs dist diff {err} > 1e-6")
        plain_cand[name] = (pv, pi)
        scan_1m_err = max(scan_1m_err, err)

    cv, ci = plain_cand["text"]
    pv, pi, _ = scoring.rescore_candidates(cv, ci, dindex.vectors, txt_emb, k=K)
    text_agree = exact.topk_agree(tv.cpu().numpy(), ti.cpu().numpy(), pv.cpu().numpy(),
                                  pi.cpu().numpy(), atol=1e-6)
    require(text_agree, "text queries: kernel path top-10 differs from the plain path")

    group_ids = torch.from_numpy(index.snapshot("clip").group_ids).to(dev)
    exact_ids = []
    for lo in range(0, N_GAUSS, 64):
        _, ei, _ = exact.exact_search(dindex.vectors, dindex.row_valid, group_ids, gq[lo:lo + 64],
                                      num_groups=N_ROWS, k=K)
        exact_ids.append(ei)
    exact_ids = torch.cat(exact_ids).cpu().numpy()
    got_ids = si.cpu().numpy()
    recall = float(np.mean([len(set(exact_ids[i]) & set(got_ids[i])) / K for i in range(N_GAUSS)]))
    require(recall >= 0.99, f"recall@10 {recall} < 0.99")

    text_ms = cuda_ms(torch, lambda: clip.embed_texts(params, cfg, token_ids), reps=10)
    search_ms = cuda_ms(torch, lambda: dindex.search(gq, K, oversample=OVERSAMPLE), reps=10)
    codes_1m = (dindex.codes, dindex.sumsq, dindex.row_valid, codec.quantize_int8(gq, scale))
    scan_1m_ms, scan_1m_plain_ms = paired_ms(
        torch, lambda: int8_scan.int8_topk(*codes_1m, k=K * OVERSAMPLE),
        lambda: int8_scan.int8_topk_plain(*codes_1m, k=K * OVERSAMPLE), reps=5)
    # One query at a time, the interactive search.
    search_q1_ms = cuda_ms(torch, lambda: dindex.search(gq[:1], K, oversample=OVERSAMPLE), reps=20)
    codes_1m_q1 = (*codes_1m[:3], codes_1m[3][:1])
    scan_1m_q1_ms, scan_1m_q1_plain_ms = paired_ms(
        torch, lambda: int8_scan.int8_topk(*codes_1m_q1, k=K * OVERSAMPLE),
        lambda: int8_scan.int8_topk_plain(*codes_1m_q1, k=K * OVERSAMPLE), reps=20)
    emit({"phase": "main", "card": smi, "config": "ViT-B-32 bf16, seeded random weights",
          "images": N_IMAGES, "rows": N_ROWS, "dim": DIM, "launches": launches,
          "attention_routes": routes,
          "recall_at_10": recall, "text_top10_equals_plain": text_agree,
          "int8_topk_1m_max_abs_err": scan_1m_err,
          "image_embed_img_per_s": img_per_s, "text_embed_ms_per_batch_of_64": text_ms,
          "search_qps_q256_k10": N_GAUSS / (search_ms / 1e3), "search_ms_q256": search_ms,
          "int8_topk_1m_q256_k80_ms": scan_1m_ms, "int8_topk_1m_q256_k80_plain_ms": scan_1m_plain_ms,
          **{"int8_topk_1m_q256_k80_" + key: value
             for key, value in scan_roofline(codes_1m, K * OVERSAMPLE).items()},
          "int8_topk_1m_q256_gemm_only_ms": gemm_only_ms(torch, codes_1m),
          "search_qps_q1_k10": 1 / (search_q1_ms / 1e3), "search_ms_q1": search_q1_ms,
          "int8_topk_1m_q1_k80_ms": scan_1m_q1_ms, "int8_topk_1m_q1_k80_plain_ms": scan_1m_q1_plain_ms,
          **{"int8_topk_1m_q1_k80_" + key: value
             for key, value in scan_roofline(codes_1m_q1, K * OVERSAMPLE).items()},
          "int8_topk_1m_q1_gemm_only_ms": gemm_only_ms(torch, codes_1m_q1, reps=20),
          "host_index_build_s": host_build_s, "host_index_build_numpy_s": host_build_numpy_s,
          "host_codec_native_calls": native_quant_calls, "native_codes_equal_numpy": True,
          "build_quant_s_native_numpy_numpy_native": [quant_s["native"][0], quant_s["numpy"][0],
                                                      quant_s["numpy"][1], quant_s["native"][1]],
          "upload_s": upload_s})
    del params, img_emb, embeds, codes_1m, codes_1m_q1, txt_emb

    # 6. The batched search on the same index. Counters start at zero here.
    batch = batch_path(torch, dev, smi, dindex, group_ids, scale, counters)
    batch_launches = batch.pop("launches")
    batch_routes = read_routes(counters)
    emit({"phase": "batch", "launches": batch_launches, **batch})
    del index, dindex, group_ids, gq
    torch.cuda.empty_cache()

    # 8. The composed two-space RRF (bench.py): B1 at k·oversample = 1,024,
    # then the fusion. Counters start at zero inside.
    composed = composed_path(torch, dev, smi, counters)
    composed_launches = composed.pop("launches")
    composed_routes = read_routes(counters)
    emit({"phase": "composed", "launches": composed_launches, **composed})

    # 7. The serving embed: ViT-L/14 static int8 through ClipImpl.predict.
    reset_counts(counters)
    l14 = int8_embed_path(torch, dev, smi, counters)
    l14_launches = {fn.__name__: fn.launches for fn in counters}
    l14_routes = read_routes(counters)
    require(all(l14_launches[name] > 0 for name in ("int8_topk", "mha", "mha_qkv", "ln_quant_2d")),
            f"int8 path kernel launches {l14_launches}")
    require_tensor_cores(l14_launches, l14_routes, ("mha", "mha_qkv"), "int8 embed")
    emit({"phase": "int8", "launches": l14_launches, "attention_routes": l14_routes, **l14})
    l14_scan_err = l14["int8_topk_max_abs_err"]

    del l14
    torch.cuda.empty_cache()

    # 9. A PQL page through the port's Executor.execute: (a) BASELINE #5's
    # three-space OR of RRF leaves, (b) one leaf a text embedded through the
    # model manager, (c) a small DB on the card and on the CPU. Counters
    # start at zero here.
    reset_counts(counters)
    or3, or3_ex = or3_path(torch, dev, smi, counters)
    text_leaf = text_leaf_path(torch, dev, smi, or3_ex, counters)
    del or3_ex
    torch.cuda.empty_cache()
    db_run = db_path(torch, dev, smi)
    pql_launches = {fn.__name__: fn.launches for fn in counters}
    pql_routes = read_routes(counters)
    require(pql_launches["int8_topk"] > 0 and pql_launches["mha"] > 0,
            f"pql path kernel launches {pql_launches}")
    require_tensor_cores(pql_launches, pql_routes, ("mha",), "pql text leaf")
    emit({"phase": "pql", "launches": pql_launches, "attention_routes": pql_routes,
          "or3": or3, "text_leaf": text_leaf, "db": db_run})

    # 10. Text search: (a) the two text encoders through the model manager,
    # (b) BASELINE #4's hybrid FTS × embedding page over HYBRID_ROWS chunks,
    # (c) a DB with real text embeddings on the card and on the CPU.
    # Counters start at zero here.
    torch.cuda.empty_cache()
    reset_counts(counters)
    text_run, text_mgr = text_embed_path(torch, dev, smi, counters)
    hybrid = hybrid_path(torch, dev, smi, text_mgr, counters)
    torch.cuda.empty_cache()
    text_db = text_db_path(torch, dev, smi, text_mgr)
    text_mgr.shutdown()
    text_launches = {fn.__name__: fn.launches for fn in counters}
    text_routes = read_routes(counters)
    require(text_launches["mha"] > 0 and text_launches["int8_topk"] > 0,
            f"text path kernel launches {text_launches}")
    require_tensor_cores(text_launches, text_routes, ("mha",), "text encoders")
    emit({"phase": "text", "launches": text_launches, "attention_routes": text_routes,
          "embed": text_run, "hybrid": hybrid, "db": text_db})

    # 11. The build path: (a) N_BUILD OCR rows embedded by mpnet-base through
    # the JobQueue, run_extraction_job and the reconcile, (b) hard checks on
    # what was built, (c) the built space searched through Executor.execute,
    # (d) a build on the card and on the CPU. Counters start at zero here.
    del text_mgr
    torch.cuda.empty_cache()
    reset_counts(counters)
    extract = extract_path(torch, dev, smi, counters)
    torch.cuda.empty_cache()
    extract.append(extract_pair_path(torch, dev, smi))
    extract_launches = {fn.__name__: fn.launches for fn in counters}
    extract_routes = read_routes(counters)
    require(extract_launches["mha"] > 0 and extract_launches["int8_topk"] > 0,
            f"build path kernel launches {extract_launches}")
    require_tensor_cores(extract_launches, extract_routes, ("mha",), "build path")
    for record in extract:
        emit({"phase": "extract", **record})
    emit({"phase": "extract", "part": "launches", "launches": extract_launches,
          "attention_routes": extract_routes})

    # 12. The audio path: (a) 256 WAV files through the whisper and clap jobs,
    # (b) hard checks, (c) search, (d) a whisper window's split, (e) the card
    # against the CPU, (f) B3 at the path's shapes. Counters start at zero
    # here.
    torch.cuda.empty_cache()
    reset_counts(counters)
    audio_run = audio_path(torch, dev, smi, counters)
    audio_launches = {fn.__name__: fn.launches for fn in counters}
    audio_routes = read_routes(counters)
    require(audio_launches["mha"] > 0 and audio_launches["int8_topk"] > 0,
            f"audio path kernel launches {audio_launches}")
    require_tensor_cores(audio_launches, audio_routes, ("mha",), "audio path")
    require(not torch.backends.cuda.matmul.allow_tf32, "audio: TF32 is on for f32 matmuls")
    torch.cuda.empty_cache()
    audio_run.append(audio_pair_path(torch, dev, smi))
    audio_b3 = audio_attention(torch, dev, smi, counters)
    audio_run.append(audio_b3)
    for record in audio_run:
        emit({"phase": "audio", **record})
    emit({"phase": "audio", "part": "launches", "launches": audio_launches,
          "attention_routes": audio_routes})

    # 13. Image tags and captions: (a) 1,024 PPM images scanned, (b) the
    # tagger in bf16 and int8, (c) the tag build and match_tags pages, (d)
    # the captioner and the VLM tagger, (e) the card against the CPU, (f) B3,
    # B4 and B5 at the tagger's shapes. Counters start at zero here.
    torch.cuda.empty_cache()
    reset_counts(counters)
    tag_run, tag_pair = tag_path(torch, dev, smi, counters)
    tag_launches = {fn.__name__: fn.launches for fn in counters}
    tag_routes = read_routes(counters)
    require(all(tag_launches[name] > 0 for name in ("mha", "mha_qkv", "ln_quant_2d")),
            f"tag path kernel launches {tag_launches}")
    require_tensor_cores(tag_launches, tag_routes, ("mha", "mha_qkv"), "tag path")
    torch.cuda.empty_cache()
    tag_pair_rec = tag_pair_path(torch, dev, smi, tag_pair)
    tag_run.append(tag_pair_rec)
    tag_k = tag_kernels(torch, dev, smi, counters)
    tag_run.append(tag_k)
    for record in tag_run:
        emit({"phase": "tags", **record})
    emit({"phase": "tags", "part": "launches", "launches": tag_launches,
          "attention_routes": tag_routes})

    # 14. OCR: (a) 256 PGM pages scanned, (b) the CTC and attention readers'
    # jobs, (c) hard checks and match_text pages, (d) the card against the
    # CPU, (e) B3 at the trunk's shape and past D 128. Counters start at zero
    # here.
    torch.cuda.empty_cache()
    reset_counts(counters)
    t14 = time.perf_counter()
    ocr_run, ocr_pages = ocr_path(torch, dev, smi, counters)
    ocr_launches = {fn.__name__: fn.launches for fn in counters}
    ocr_routes = read_routes(counters)
    require(ocr_launches["mha"] == ocr_run[1]["expected_b3_launches"]
            and all(n == 0 for name, n in ocr_launches.items() if name != "mha"),
            f"ocr path kernel launches {ocr_launches}, B3 expected "
            f"{ocr_run[1]['expected_b3_launches']}")
    require_tensor_cores(ocr_launches, ocr_routes, ("mha",), "ocr path")
    torch.cuda.empty_cache()
    ocr_run.append(ocr_pair_path(torch, dev, smi, ocr_pages))
    ocr_k = ocr_kernels(torch, dev, smi, counters)
    ocr_run.append(ocr_k)
    for record in ocr_run:
        emit({"phase": "ocr", **record})
    emit({"phase": "ocr", "part": "launches", "launches": ocr_launches,
          "attention_routes": ocr_routes, "phase_s": time.perf_counter() - t14})

    runs = ((launches, routes), (batch_launches, batch_routes), (composed_launches, composed_routes),
            (l14_launches, l14_routes), (pql_launches, pql_routes), (text_launches, text_routes),
            (extract_launches, extract_routes), (audio_launches, audio_routes),
            (tag_launches, tag_routes), (ocr_launches, ocr_routes))
    total = {name: sum(run[0][name] for run in runs) for name in launches}
    total_routes = {name: {path: sum(run[1][name][path] for run in runs) for path in routes[name]}
                    for name in routes}
    emit({"kernels": [
        {"name": "int8_topk", "route": "cuda", "source": "panoptikon_tpu_torch/csrc/int8_scan.cu",
         "replaces": "panoptikon_tpu/ops/pallas_scan.py:138", "launches": total["int8_topk"],
         "max_abs_err": max(scan_err, scan_l2_err, *b1_err.values(), scan_1m_err,
                            composed["int8_topk_max_abs_err"], l14_scan_err,
                            *(r["b1_k40_max_abs_err"]
                              for r in or3["per_space_recall_at_10_and_b1"].values()),
                            hybrid["recall_at_10_and_b1"]["b1_k40_max_abs_err"],
                            extract[2]["b1_k40_max_abs_err"], audio_run[2]["b1_k40_max_abs_err"]),
         "ms": scan_ms, "plain_ms": scan_plain_ms, **scan_bound, "library_ms": None},
        {"name": "int8_topk_v2", "route": "cuda", "source": "panoptikon_tpu_torch/csrc/int8_scan.cu",
         "replaces": "panoptikon_tpu/ops/pallas_scan.py:321", "launches": total["int8_topk_v2"],
         "max_abs_err": max(*v2_err.values(), batch["int8_topk_v2_max_abs_err"]),
         "ms": v2_ms["cosine"][0], "plain_ms": v2_ms["cosine"][1], **v2_bound,
         "library_ms": None},
        {"name": "mha", "route": "cuda", "source": "panoptikon_tpu_torch/csrc/attention.cu",
         "replaces": "panoptikon_tpu/ops/vit_attention.py:192", "launches": total["mha"],
         "routes": total_routes["mha"],
         "max_abs_err": max(*attn_err.values(),
                            *(r["max_abs_err"] for r in audio_b3["shapes"].values()),
                            tag_k["mha"]["max_abs_err"],
                            *(r["max_abs_err"] for r in ocr_k["shapes"].values())),
         "ms": attn_ms["vit_b32_image"][0], "plain_ms": attn_ms["vit_b32_image"][1],
         **bounds["vit_b32_image"], "library_ms": library_ms["vit_b32_image"],
         "text_shapes": {name: {"ms": attn_ms[name][0], "plain_ms": attn_ms[name][1],
                                "max_abs_err": attn_err[name], **bounds[name],
                                "library_ms": library_ms[name]} for name in TEXT_ATTN_CASES},
         "audio_launches": audio_launches["mha"], "audio_shapes": audio_b3["shapes"],
         "tag_launches": tag_launches["mha"], "tag_shape": tag_k["mha"],
         "ocr_launches": ocr_launches["mha"], "ocr_shape": ocr_k["shapes"]["ocr_trunk"],
         "wide_head_dim_shapes": {name: r for name, r in ocr_k["shapes"].items()
                                  if name != "ocr_trunk"},
         "captioner_decoder_logits_d384": tag_pair_rec["decoder_logits_d384"]},
        {"name": "mha_qkv", "route": "cuda", "source": "panoptikon_tpu_torch/csrc/attention.cu",
         "replaces": "panoptikon_tpu/ops/vit_attention.py:296", "launches": total["mha_qkv"],
         "routes": total_routes["mha_qkv"],
         "max_abs_err": max(*qkv_err.values(), tag_k["mha_qkv"]["max_abs_err"]),
         "ms": qkv_ms["vit_l14_image_int8"][0],
         "plain_ms": qkv_ms["vit_l14_image_int8"][1], **bounds["qkv_vit_l14_image_int8"],
         "library_ms": None, "tag_launches": tag_launches["mha_qkv"],
         "tag_shape": tag_k["mha_qkv"]},
        {"name": "ln_quant", "route": "cuda", "source": "panoptikon_tpu_torch/csrc/ln_quant.cu",
         "replaces": "panoptikon_tpu/ops/ln_quant.py:60", "launches": total["ln_quant_2d"],
         "max_abs_err": max(*ln_err.values(), tag_k["ln_quant"]["max_abs_err"]),
         "ms": ln_ms["vit_l14_image"][0],
         "plain_ms": ln_ms["vit_l14_image"][1], **bounds["ln_vit_l14_image"], "library_ms": None,
         "tag_launches": tag_launches["ln_quant_2d"], "tag_shape": tag_k["ln_quant"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
