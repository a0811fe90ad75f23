#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU and
hold every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; a failure in any of them ends the run with a traceback
and a nonzero exit code, and no result line:

1. build        compile every kernel under protein_clip_tpu_torch/csrc/ with
                nvcc for sm_90a, one nvcc per source, all at once, and
                beside them the planted faults (FAULTS), each built from a
                patched copy under _build/fault/<name>/, never loaded by
                the package: dense_mm, ffn_gelu and ffn_gelu_f32 whose
                shared main loop drops its last k-tile, and ffn_gelu_f32
                with one TF32 product a k-step; attention_fwd and
                attention_bwd (and
                their f32 kernels) whose swept loop (K1's keys, K5's dk/dv
                queries) drops its last tile; the same four whose skip
                predicate is off by one at a segment boundary;
                filip_maxsim whose b-tile skip predicate misses a tile's
                first token, and filip_maxsim in plain TF32 (the two
                correction products dropped); infonce in plain TF32, and infonce whose
                cross-block sums of the forward's partials drop the last,
                partial tile; print the card's name and power limit.
2. kernels      K1 (segment-masked attention forward) against
                ops.attention.attention_reference at the serving shapes
                and at T around a tile (65, 127, 128, 129) (NH=20, dh=32,
                bf16), and at each other family's attention shape
                (FAMILY_SHAPES: dh 16, 24, 64 at NH 20 and 40, 128 at NH
                40) padded, with a fully padded row, packed and at odd T
                (65, 129), with padded rows (fully padded query rows included)
                and packed rows (several segments, gap zeros), among them
                the packed paths' own chunks (path_segments): the last
                chunk of each side of cli.main --packed's first global
                batch on the 3000-family fixture (the packed run trains on
                1100 families: the same chunk shapes), (16, 128) and
                (16, 256) with their
                all-<pad> rows, the last pep chunk of cli.main --packed
                --finetune's, (48, 128), and a (16, 512) and a (28, 2048)
                receptor chunk of tools/bench_train's draws; its statistics
                against attention_reference_lse (LSE_ATOL). K4 (FILIP masked max-sim) against
                ops.filip.maxsim_reference at the scorer's shapes (D=128,
                f32), with padded masks, an all-masked a-row and b-row, a
                b-row whose second tile holds one valid token, token counts
                that are not multiples of 64, (K4_SHORT_SHAPES) tokens
                of norm 2 with 1-4 valid tokens a row, where plain TF32's
                error shows past K4_ATOL, and (K4_EMPTY_SHAPES) a query
                with no valid token at the /topk grid. K2 and K3
                (InfoNCE, forward and backward through autograd) against
                ops.infonce.clip_infonce: unit rows scaled by exp(t/2) for
                t in {1, 4}, K2 at B in {16, 100, 256, 512}, K3 at B in
                {1000, 1024, 2048, 4096}, D=128, and each at D=64 once;
                both planted InfoNCE faults must fail that check (the
                partial-tile fault every case at B = 100 and 1000).
                K5 (segment-masked attention backward) against
                ops.attention.attention_reference_bwd at the finetune
                chunks' shapes (16 rows at the pep and rec buckets 32 and
                192), at K1's timing shape and at odd T, NH=20, bf16, with
                padded, fully padded and packed rows, and on the packed
                unfrozen path's four chunks above, fed K1's statistics; and
                at the other families' shapes as K1. K1-f32 and K5-f32
                (attention_fwd_f32, attention_bwd_f32) against the same
                plain versions on f32 inputs (F32_ATOL_RMS, F32_RTOL) at
                (16, 512) with a fully padded row, odd T, every packed
                path chunk of path_segments (tools/bench_train's (16, 512)
                and (28, 2048) receptor chunks among them), each
                family's shapes, and at every head dim one-token
                segments, T = 1 and segments of 2-8 tokens; both
                attention faults must fail them as they fail K1 and K5,
                and so must the f32 kernels in plain TF32
                (attention_f32_tf32). P1 (dense_mm) s8 ->
                s32 against ops.dense_mm.mm_reference to the bit at the
                probe's (8192, 2560, 2560), at N in {1, 128, 1000, 3072,
                10240} tokens through t30_150M's three layer shapes, at the
                main loop's edges (EDGE_SHAPES: N around its 64- and
                256-row blocks, K below, at and past one ring stage, M = 8
                and M no multiple of its blocks' columns) and at the extreme
                values; bf16 -> f32 within MM_BF16_TOL of |x| @ |w| at the
                probe's shape, the three layer shapes at 128 and 10240
                tokens and the edges. K6 (ffn_gelu) against
                ops.ffn.dense_gelu_reference at N in {64, 128, 3072, 10240},
                H=640, M=2560, erf and tanh, and at the edges (erf):
                FFN_ULPS bf16 ulps per output and at most FFN_SHARE of them
                off; the plain version with either epilogue rounding skipped
                must fail that. K6-f32 (ffn_gelu_f32) against
                dense_gelu_reference in f32 (TF32 off; F32_ATOL_RMS,
                F32_RTOL) at t30_150M's wi for K6_ROWS tokens, erf and
                tanh, at the edges (EDGE_SHAPES and K6_F32_EDGES, where the
                128 x 128 tile has a partial last row and column tile) and
                at each family's wi (FFN_WIDTHS) for K6_F32_FAMILY_ROWS
                tokens. Then each check against its planted faults,
                which must fail it (by how much is printed): P1 and K6
                against their main loop's, K6-f32 against the same loop's
                and against plain TF32 (each every case), K1 and K5
                against the swept-loop
                and the skip faults (the skip fault every packed case,
                both faults every chunk of the packed unfrozen path and a
                case at each head dim of FAULT_HEAD_DIMS), K4
                against its skip fault (every case with the one-token tile)
                and its plain-TF32 fault, K2 and K3 against theirs.
3. serve        ESM-2 t30_150M in bf16 with seeded random weights and CLIP
                heads, written as npz; an index of 256 synthetic sequences
                built with cli.embed; cli.serve's server on an ephemeral port
                answers /healthz, single-sequence /embed at the
                64/128/512/2048 buckets on both sides, a 32-sequence /embed,
                the binary wire, /topk and 16 concurrent clients. The K1
                launch count must be 30 per backbone forward, and P1 and K6
                must not launch.
4. e2e          the served embeddings against the same sequences encoded
                with attention_impl="eager": cosine >= 0.999 per row.
5. filip serve  FILIP heads (seeded, written as npz) over the same backbone:
                a ragged index of 256 sequences built with cli.embed --filip;
                cli.serve --filip answers /healthz, JSON and binary /embed
                (with its length prefix) and /topk, whose scores and order
                are held against the plain max-sim on the card;
                cli.retrieve --filip returns /topk's hits, and cli.retrieve
                in CLIP mode runs against phase 3's index. K4 launches once
                per (64-query, 1024-candidate) block of each scorer call; K1
                30 times per backbone forward.
6. filip e2e    the served token embeddings against the same sequences
                encoded with attention_impl="eager": cosine >= 0.99 for
                every valid token.
6b. t33_650M    ESM-2 t33_650M (33 layers, hidden 1280, 20 heads of 64)
                in bf16 with seeded random weights and CLIP heads written
                as npz: cli.embed builds a 64-sequence index, cli.serve
                answers /healthz, single-sequence /embed at buckets 64 and
                512 on both sides and a 32-sequence /embed; K1 33 times per
                backbone forward; cosine >= 0.999 per row against eager
                attention; /embed p50 and batch-32 seqs/s. Then the other
                families (FAMILY_RUNS: t6_8M and t12_35M at full depth,
                t36_3B and t48_15B at full width and 2 layers) through
                esm2.forward on padded and packed rows: K1 once a layer,
                valid tokens at cosine >= 0.999 against eager.
6c. hf, f32     t30_150M as an EsmForMaskedLM directory of seeded f32
                weights (write_hf_dir: config.json and a model.safetensors
                written by hand, the MLM and contact heads and the rotary
                inv_freq beside the esm.-prefixed backbone): the reader
                returns the backbone and nothing else, load_esm --esm-dtype
                float32 places every array to the bit, and the port's
                convert_esm_weights writes an npz that loads to the same
                tree. cli.serve --esm-dtype float32 --esm-weights <that
                directory> over phase 3's heads and index: /embed of one
                sequence and of 32; K1-f32 30 times per forward, no bf16
                K1; cosine >= F32_COSINE_MIN per row against eager f32
                attention on the same weights; a server of the npz answers
                the same requests equal to the bit. Then PCT_FFN_PALLAS=1
                cli.serve --esm-dtype float32 of the same directory
                (load_esm takes the gate in f32): the same requests,
                K6-f32 and K1-f32 30 times each per forward, no bf16 K6,
                K1 or P1, cosine >= F32_COSINE_MIN per row against the
                gate-off f32 server; /embed p50 and batch-32 seqs/s.
7. train        cli.main twice, t30_150M bf16 with seeded random weights,
                one epoch: the defaults (16 x 16 = global batch 256 in 4
                length groups, 16 chunks: K2) on a synthetic fixture of
                1100 families (SMALL_DATA: three steps, 20 eval batches),
                and --batch-size 64 (global batch 1024: K3) on one of 3000
                families (two steps). Each run must write
                losses_per_epoch.txt (finite), metrics.jsonl,
                best_model.npz, one train-state snapshot (state/) and the
                raw and trained heatmaps' matrices (figures/*.npy; their
                two backbone forwards a heatmap are counted apart, as the
                "figures" path, count_figures); K1 launches 30 times per
                backbone forward
                (32 forwards per step, 8 per eval batch); K2 and K3 once
                forward and once backward per step and once forward per eval
                batch, each on its own pools; P1 and K6 never. cli.embed then
                embeds with run 1's best_model.npz. Then the unfrozen modes
                on the same fixture: cli.main --finetune and cli.main
                --lora-rank 8 at the defaults (global batch 256 in one pad
                bucket, 16 chunks, remat, two learning rates), one epoch
                each, with the same artifact checks; per step K1 launches 30
                times per pass-1 forward and 60 per pass-2 chunk (forward and
                remat recompute), K5 30 times per pass-2 chunk, K2 once
                forward and once backward; per eval batch K1 60 times and K2
                once. cli.embed embeds with each run's best_model.npz (the
                finetuned backbone; the adapters merged into the base).
                Then cli.main --packed at the defaults (global batch 256,
                flat packing, chunks of 16 packed rows) for one epoch on
                the 1100-family fixture: the
                artifacts; the backbone's chunk forwards, and K1 30 times
                each, exactly as many as the loaders' batches take when
                packed again here (packed_epoch_chunks); K2 once forward
                and once backward per step and once forward per eval batch;
                cli.embed with its best_model.npz. The 256 pairs' pooled
                embeddings through embed_packed (K1 on packed segments)
                against the grouped path (K1 on padded rows): cosine >=
                COSINE_MIN per row; one packed step run twice from the same
                state and generator seed gives the same loss and heads to
                the bit; one packed and one grouped step under
                torch.profiler: kernel launches and device busy share.
                Then cli.main --packed --finetune and --packed --lora-rank
                8 at the defaults for one epoch each: the artifacts; the
                chunk forwards of each pass exactly as many as the loaders'
                batches take when packed again here by the unfrozen step's
                constant-token rule (unfrozen_chunks: 9 a pass on the
                fixture); per step K1 30 times per pass-1 chunk and 60 per
                pass-2 chunk, K5 30 per pass-2 chunk, K2 once forward and
                once backward; per eval batch K1 30 per chunk forward and
                K2 once; cli.embed with each run's best_model.npz; one
                packed finetune step under torch.profiler: launches, busy
                share and peak memory. (The one-bucket and the packed
                finetune and LoRA runs train on a 1000-family fixture,
                ONE_BUCKET_DATA, two steps each; the packed ones on the
                1100-family fixture, SMALL_DATA.)
                Then t33_650M on the 1100-family fixture: cli.main
                --esm-config t33_650M --packed and --packed --finetune for
                one epoch each, their chunk forwards and launches against
                the loaders (K1 33 per chunk forward; unfrozen: 33 per
                pass-1 chunk, 66 per pass-2 chunk, K5 33 per pass-2
                chunk), cli.embed with each checkpoint; 256 pairs' packed
                embeddings through K1 against K1's plain version (cosine
                >= 0.999); the packed step through K2 against the plain
                loss (as phase 8) and the packed finetune step through K5
                against its plain version (FT_K5_TOL, the swept-tile fault
                past it, to the bit), both at global batch 32; one packed
                finetune step at 256 under torch.profiler (launches, busy
                share, peak memory).
                Then f32: cli.main --packed --finetune --esm-dtype float32
                on the 1100-family fixture (K1-f32 and K5-f32 in K1's and
                K5's counts, no bf16 attention, peak memory), and the same
                under PCT_FFN_PALLAS=1 (K6-f32 as often as K1-f32: 30 per
                pass-1 chunk, 60 per pass-2 chunk, 30 per eval chunk; no
                bf16 K6); one packed frozen f32 step at 256 with the gate
                off and on (K1-f32 30 per chunk forward, K6-f32 as many
                under the gate; the gated loss within
                K6_F32_STEP_LOSS_TOL of the gate-off one), and the f32
                packed finetune step at 256 through K1-f32/K5-f32 against
                the step through K5-f32's plain version (every leaf within
                F32_FT_TOL of its largest; K5-f32's swept-tile fault past
                it), and against it the same step under the gate (K6-f32):
                with ReLU heads the loss within FT_LOSS_TOL, run twice equal
                to the bit, its leaves beside the same step with the wi
                product in exact f32 in another order; with
                F32_SMOOTH_HEADS every leaf within F32_FT_TOL, K6-f32's
                k-tile and plain-TF32 faults past it.
                Then FILIP training: cli.main_2protein_filip for one epoch
                on a fixture of 1100 families (protein1/protein2), at its
                defaults (batch 10, one pad bucket, 1 chunk) and at its
                documented scale-up with DCL (--batch-size 128 --num-chunks
                8 --length-groups 4 --use-dcl): the artifacts; K1 30 times
                per backbone forward (2 forwards a batch at 10, 16 at 128),
                K4 groups^2 times per step and per eval batch, no other
                kernel (FILIP's loss is plain PyTorch). K4 against its
                plain version on the path's own blocks (the first train
                batch encoded by each run's best heads: (10, 10, 32, 192)
                and the grouped run's 16 rectangular blocks), on the first
                and last of them with an emptied a-row and b-row, with tied
                tokens, with b-row 0 cut to 65 tokens and at norm 2 with
                1-4 valid tokens a row; both planted K4 faults must fail
                it (the skip fault every case with a one-token tile, plain
                TF32 every short case). The max-sim backward through the
                wrapper against autograd through maxsim_reference in
                float64 on the card, on those blocks with tokens rounded to
                1/16 and tied (exact scores, the same ties), with the
                path's masks and with emptied rows: MAXSIM_BWD_RTOL.
                cli.retrieve --filip with the batch-10 run's best_model.npz
                against the plain max-sim.
                Then the rest of FILIP training on the same fixture
                (FILIP_MORE_RUNS, one epoch each): --packed at batch 128
                with 4 scatter tiers (the CLI's default) and with 1, and
                --finetune and --lora-rank 8 at batch 64 in 2 chunks, one
                bucket and --packed: the artifacts; the backbone forwards
                and the K1, K4 and K5 launches exactly as the loaders'
                batches, tokenized again here, predict (filip_epoch_plan:
                K4 once per tier-pair block that holds sequences); embed
                --filip with the packed unfrozen runs' checkpoints. K4
                against its plain version on the packed run's first batch's
                tier-pair blocks (phantom rows included), their variants,
                and a block whose a-tier or b-tier is sentinels only; both
                planted K4 faults must fail their cases; the f32 max-sim
                backward on those blocks against float64 autograd
                (MAXSIM_TIER_BWD_RTOL; a backward that splits ties
                unevenly must fail it), and on float64 tokens
                (MAXSIM_BWD_RTOL). K1 and
                K5 against their plain versions on the packed FILIP steps'
                own chunks.
7c. resume, eval
                cli.main --packed --finetune on the 1000-family fixture (two
                steps an epoch) and cli.main_2protein_filip --packed
                --batch-size 128 on the FILIP fixture (six), each three
                times: two epochs unbroken, one epoch, and --epochs 2
                --resume-dir on the one-epoch run's directory; the resumed
                run's epoch-2 CSV row, metrics.jsonl losses, best_model.npz
                and final snapshot equal the unbroken run's to the bit, one
                snapshot is left in state/, and every kernel's launches in
                the resumed run less its test evaluation equal the unbroken
                run's less the one-epoch run's (RESUME_RUNS,
                run_resume_phase). Then cli.topk at --n-candidates 256,
                padded and --packed with the 256 run's best_model.npz on
                the 3000-family fixture's val split, and --filip with the
                batch-10 FILIP run's on the FILIP fixture's train split:
                the padded and packed embeddings per row at cosine >=
                COSINE_MIN and their ranks equal but at near-ties (a
                query's ranks differ by at most its candidates within twice
                the largest logit difference of its true partner's);
                --filip's scores within K4_ATOL of the plain max-sim's on
                the same tokens and its ranks equal theirs but at such
                near-ties; the printed accuracies those of the ranks.
                cli.cosine_similarity writes three finite matrices in [-1,
                1]. K1 30 per backbone forward (32 padded, one per packed
                chunk, 6 for the heatmaps), K4 once per 64-query block
                (run_eval_phase).
7d. tiers, mlm  width tiers on a fixture of LONGTAIL_PAIRS pairs whose
                receptors follow bench.py's long-tail lengths (90% of
                100-399 residues, 10% of 1200-1998): cli.main --packed
                --pack-tiers 4 for one epoch (global batch 256), its chunk
                forwards and K1 (30 each) and K2 launches against the
                loaders' batches packed again here from cleared tier
                caches; the first batch's (rows, width) per pack and slots
                against the flat wire; one step on it through K2 against
                the plain loss (1e-5) and against the flat-packed step on
                the same pairs (the loss within TIER_STEP_TOL in f32, the
                bf16 gap printed); K1 against its plain version on the
                first and last chunk of each pack and on a placeholder
                pack's all-<pad> chunk, and both attention faults, each of
                which must fail a chunk. cli.main_2protein_filip --packed
                --pack-tiers 4 at batch 128 on the same corpus: K1 per
                chunk forward, K4 once per (pep pack or tier, rec pack)
                block, against its batches; K4 on the blocks the path
                forms (phantom rows included) and both K4 faults; one step
                through K4 against the plain max-sim (FILIP_STEP_TOL).
                Then cli.mlm_train at --batch-size MLM_BATCH for one epoch
                on the 1100-family fixture: the LM head alone on padded
                rows, --packed, and --packed --finetune (K1 30 a forward,
                60 a finetune step with the remat recompute, K5 30 a
                finetune step; one forward a batch); on the first packed
                batch with fixed masks the head step through K1 against
                K1's plain version (MLM_LOSS_RTOL) and the finetune step
                through K1/K5 against K5's plain version (FT_LOSS_TOL,
                FT_K5_TOL, the swept-tile fault past it), with the
                finetune step's peak memory; cli.mlm_sweep over 200
                peptides.
7e. dp          the data-parallel mesh (protein_clip_tpu_torch/parallel,
                run_dp_phase). (a) In an NCCL world of one rank on the
                card, one step of each DP_WORLD1_STEPS configuration
                through parallel/engine.MeshEngine (CLIP frozen one bucket
                and packed, packed finetune and LoRA; FILIP packed frozen
                and finetune; t30_150M bf16, dropout 0, CLIP at 64 pairs,
                FILIP at 32) against the single-device engine's step on the
                same device batch: equal to the bit (loss, every gradient,
                every updated leaf); the mesh step's launches, counted from
                0, equal the single-device step's, with K1, K2, K4 and K5
                each among them where the path runs it; each step's
                seconds (a second call) and peak memory beside the
                single-device step's; pmean_grads timed alone on each
                step's gradients, with the memory it adds. (b) Two gloo ranks spawned on the
                one card (the kernels this process built): the packed CLIP
                frozen step, the padded FILIP frozen step and the packed
                CLIP finetune step, f32 (K1-f32, K5-f32, K2, K4), 16 pairs
                a rank, the ranks' losses and gradients equal to the bit,
                against the single-device step on the same rows within
                DP_GLOO_TOL (F32_FT_TOL for the finetuned backbone's
                leaves); both ranks' launches returned. (c)
                cli.main_2protein --dp 2 exits nonzero before anything
                loads, naming the one visible card.
7f. tp          tensor parallelism, the 'model' mesh axis (run_tp_phase).
                Two gloo ranks spawned on the one card, a (1, 2) mesh of
                t30_150M: (a) the forward of TP_FWD_SEQS fixture receptors
                on a rank's Megatron slices (K1 on its 10 of 20 heads, 30
                launches a forward; the row linears' bf16 partials through
                P1, 60) against the one-device forward: bf16 and gated K6
                within TP_BF16_TOL (rms of the hidden states' error over
                theirs) and pooled cosines >= TP_COS_MIN, f32 within
                TP_F32_TOL, int8 to the bit; the planted fault (the
                all-reduce after o skipped) past TP_FAULT_MARGIN x
                TP_BF16_TOL; (d) a rank's bytes of the sharded backbone
                beside the whole one's. (b) One f32 step each of
                TP_STEPS (CLIP frozen and finetune, FILIP frozen, MLM head
                and finetune; TP_PAIRS pairs) against the one-device step
                on the same batch (DP_GLOO_TOL; F32_FT_TOL for the
                finetuned backbone), both ranks equal to the bit (split
                leaves gathered). (c) The MLM head step at dp = 2 on the
                same ranks, then MLM's mesh in an NCCL world of one rank
                (head, packed head, finetune; bf16) equal to the
                one-device steps to the bit, with the same launches. (e)
                cli.main_2protein --tp 2 exits nonzero before anything
                loads, naming the one visible card.
8. step check   one default train step with K2 and one with the plain loss
                from the same heads and batch (dropout 0, Adam lr 1e-3), at
                256 and, with K3, at 1024, and one packed step with K2 at
                256: loss within 1e-5 relative,
                gradients within 1e-5 of each leaf's largest, parameters
                within the bound Adam's first update puts on them. One
                finetune step at 256 (dropout 0) from the same weights and
                batch through K1/K5, through K1 with K5's plain version
                in the same autograd Function, through K5's swept-loop
                fault build (its
                dk/dv loop drops the last query tile), and with
                attention_impl="eager" in bf16 and f32. Every leaf of the
                K1/K5 step within FT_K5_TOL of its largest entry of the
                step through K1 and K5's plain version, the loss within
                FT_LOSS_TOL, and the planted fault past that; against the
                eager step, per leaf within
                twice the eager step's distance from the f32 step plus 1e-2
                of the leaf's largest entry (check_finetune_step says why).
                The same checks on the packed finetune step over the same
                256 pairs (9 chunks a pass), whose K1/K5 step, run twice,
                must give the same loss and gradients to the bit. One FILIP
                step of each FILIP run's configuration on its first batch
                (dropout 0.1 from a seeded generator) through K4 against the
                same step through K4's plain version in the same autograd
                Function: the loss within FILIP_STEP_TOL relative and each
                head gradient within FILIP_STEP_TOL of the step's largest
                entry; run again, equal to the bit; the same step through
                each planted K4 fault is printed. The packed FILIP step at
                batch 128 (4 scatter tiers) alike, and against the same
                pairs at one scatter tier (the loss within FILIP_STEP_TOL).
                One FILIP finetune step at the runs' batch of 64 and at 256
                (FILIP_FT_CHECK_BATCH), one bucket and packed (dropout 0),
                through K1/K5 and through K1 and K5's plain version, at 256
                also through K5's swept-tile fault: every leaf within
                FILIP_FT_K5_TOL of its largest entry (four times FT_K5_TOL,
                which the FILIP step exceeds), the loss within
                FT_LOSS_TOL, the fault past it, equal to itself to the
                bit.
9. int8 serve   cli.serve --esm-dtype int8 over phase 3's weights and index
                (the w8a8 backbone: every quantised linear layer runs P1):
                /healthz, phase 3's single sequences, its 32-sequence
                /embed and /topk. P1 launches 180 times per backbone forward
                (q, k, v, o, wi, wo in 30 layers) and K1 30; the served
                embeddings equal, to the bit, the same sequences encoded
                through P1's plain version on the card; per-row cosine
                against phase 3's bf16 embeddings >= INT8_COSINE_MIN.
10. int8 train  cli.main --esm-dtype int8 for one epoch on a fixture of
                1100 families: three frozen steps at global batch 256 and
                20 eval batches; finite losses, the run's artifacts; P1
                launches 180 times per backbone forward (32 forwards per
                step, 8 per eval batch), K1 30; K2 once forward and once
                backward per step.
11. K6 serve    phase 3's server and requests with PCT_FFN_PALLAS=1 set for
                the phase: K6 launches 30 times per backbone forward (every
                FFN's wi + gelu), and the embeddings reach cosine >= 0.999
                per row against the gate off.
12. times       K1 (with and without its statistics), its plain version
                and torch's scaled_dot_product_attention at B=16, T=512,
                NH=20, padded and dense (one segment), beside K1's bound on
                the run's segments and the exponential floor at the card's
                clocks.max.sm; K1 and K5, their plain versions and SDPA
                (forward; backward) at each FAMILY_SHAPES padded, beside
                their bounds; K4 and its plain version at four queries,
                the /topk shape and a full scorer block, beside K4's bound
                on the run's masks (3xTF32 products of the allowed pairs);
                K2 forward+backward
                at (256, 128), K3 at (1024, 128) and (4096, 128), and their
                plain versions, beside the bound (3xTF32 products at the TF32
                peak), the old design's CUDA-core ceiling, the device kernels
                a call runs (torch.profiler) and the launch floor (those
                kernels times an empty kernel's device time), with the host
                (wall_ms) and without; K2 (up to its 512) and K3 side by
                side at B in {16, 128, 256, 384, 512, 1024, 2048}, the
                readings behind the dispatch rule; K5, its plain version and the
                backward of torch's scaled_dot_product_attention at B=16,
                T=512, NH=20 and at the finetune chunks' shapes, padded, and
                at (16, 512) dense, and on the packed unfrozen path's (16,
                256) and (28, 2048) chunks, beside K5's bound and
                exponential floor. P1 s8 at (8192, 2560, 2560) and (10240, 640, 2560)
                against torch._int_mm (W k-major), P1 bf16 at (8192, 2560, 2560)
                against torch.matmul, K6 at (10240, 640, 2560) against
                torch.addmm + gelu, each with its plain version and bound;
                K6-f32 at (10240, 640, 2560) against its plain version and
                torch.addmm + gelu in f32, beside its 3xTF32 bound and the
                FFMA ceiling; P1 s8, K6 and K6-f32 at 128 tokens through
                the three layer shapes (device time by
                tools/timing.kernel_times: a call there is shorter than its
                host side) beside the same library calls and bounds.
                /embed p50 for one sequence, the same encode called without
                HTTP, and seqs/s at batch 32, for bf16, int8 and
                PCT_FFN_PALLAS=1; FILIP /topk p50 for one query, and its
                parts called without HTTP. The train step in pairs/s at
                global batch 256 (median over the steps after the first of
                run 1, by CUDA events recorded after each step, with no sync
                inside the epoch), and the same for the packed, finetune,
                LoRA, packed finetune, packed LoRA and int8 runs. The FILIP
                runs' pairs/s (batch 10 and 128) by the same events; K4 on
                the first and last block of each FILIP step (call, device
                time, plain version, bound); the plain max-sim backward of
                one step's blocks by CUDA events and device time, and its
                share of the step; one FILIP step of each under
                torch.profiler: launches and busy share. The phase-7b runs'
                pairs/s by the same events; K4 over the packed step's
                tier-pair blocks and over the flat step's one block beside
                the bound on their masks; one packed frozen and one packed
                finetune FILIP step under torch.profiler: launches, busy
                share, peak memory. t33_650M's packed and packed finetune
                epochs in pairs/s by the same events. K1-f32 and K5-f32,
                their plain versions and SDPA on f32 (TF32 off) at (16,
                512, 20, 32) padded and dense and at each FAMILY_SHAPES,
                beside their 3xTF32 bounds; the f32 packed
                finetune epoch in pairs/s, with the gate off and on. K1 on
                the tier chunks beside its bound; the tiered CLIP and FILIP
                epochs in pairs/s.

Each phase's seconds are printed ([timing]) and summed at the end ([done]).
The last three lines of standard output are the card's name and power
limit, the kernels line (one JSON object per hand-written kernel) and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import functools
import gc
import inspect
import io
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import textwrap
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from protein_clip_tpu_torch.cli import common, cosine_similarity, embed, main as train_cli
from protein_clip_tpu_torch.cli import mlm_sweep, mlm_train, retrieve, serve, topk
from protein_clip_tpu_torch.cli import main_2protein_filip as filip_cli
from protein_clip_tpu_torch.data import dataset
from protein_clip_tpu_torch.data.fasta import sequences_only, write_fasta
from protein_clip_tpu_torch.data.prefetch import to_device
from protein_clip_tpu_torch.data.synthetic import write_fixture
from protein_clip_tpu_torch.eval import retrieval
from protein_clip_tpu_torch.kernels import build
from protein_clip_tpu_torch.models import clip, esm2, filip
from protein_clip_tpu_torch.models import heads as head_mod
from protein_clip_tpu_torch.ops import attention, dense_mm, ffn, infonce
from protein_clip_tpu_torch.ops import filip as maxsim
from protein_clip_tpu_torch.tools import bench_train, convert_esm_weights
from protein_clip_tpu_torch.tools.timing import graph_ms, kernel_times
from protein_clip_tpu_torch.train import (checkpoint, clip_engine, filip_engine, filip_finetune,
                                          filip_lora, filip_packed, finetune, lora, optimizer,
                                          packed_engine)
from protein_clip_tpu_torch.train.checkpoint import export_npz
from protein_clip_tpu_torch.viz import plots

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "_smoke_work"
SEED = 0
NH, DH = 20, 32                       # t30_150M attention
KERNEL_SHAPES = ((1, 64), (16, 128), (16, 512), (4, 2048), (3, 65), (3, 127), (3, 128), (3, 129))
# The other families' attention (B, T, NH, DH): t6_8M, t12_35M (24 in the
# kernels' 32-wide tiles), t33_650M, t36_3B, t48_15B. K1 and K5 run each
# padded, with a fully padded row and packed, and at odd T (65 padded, 129
# packed, B = 3), beside t30_150M's cases, and each is timed padded.
FAMILY_SHAPES = ((16, 512, 20, 16), (16, 512, 20, 24), (16, 512, 20, 64), (8, 512, 40, 64),
                 (4, 512, 40, 128))
# The head dims whose planted faults must each fail a case of their own
FAULT_HEAD_DIMS = (16, 24, 64, 128)
# K1 vs its plain version, both bf16 out: |err| <= ATOL_RMS * rms(ref) +
# RTOL * |ref|. The kernel normalises after P.V and the plain version before
# the bf16 cast of P, so they differ by bf16 rounding of P (the absolute
# term, which shrinks with the output's scale as T grows) and of the output
# (a bf16 ulp is 2^-7 relative, within RTOL). rms(ref) is taken over the
# outputs of valid queries (segment > 0; all outputs where a chunk holds
# none): a pad query's output is the mean of v's column, about 1/sqrt(T) of
# a valid one's, so on a chunk of mostly <pad> rows the chunk-wide rms
# shrinks while the valid rows' rounding does not. Emulating the kernel's
# rounding on the CPU (tests/test_torch_attention_pad.py, 40 draws of (16,
# 256) chunks) needs 0.0159 rms(ref) of the valid outputs with 2 of 16 rows
# real, 0.0177-0.0179 with 14 and 16, where the chunk-wide rms needed up to
# 0.0312 with 2 of 16 real (the limit is 0.03125; PR 18's card read 0.0341
# on such a chunk); a kernel that drops the last key tile needs 2.4
# rms(ref) or more.
ATOL_RMS, RTOL = 2 ** -5, 2e-2
# K1's statistics (base-2 log-sum-exp of a query's masked scores, values of
# a few units) against attention_reference_lse: the kernel sums
# ex2.approx terms (2^-22 relative) over 64-key tiles, the plain version
# takes one f32 logsumexp; 1e-4 is some 100 f32 ulps at these values.
LSE_ATOL = 1e-4
COSINE_MIN = 0.999
# K4 (3xTF32 on the tensor cores) against its plain version (f32 products),
# in means of maxima of dot products of tokens of norm <= 2: 3xTF32 keeps
# about f32's accuracy (a numpy emulation of the kernel's split is within
# K4_ATOL / 10 of the JAX kernel, tests/test_torch_filip.py). Plain TF32
# (the planted fault maxsim_tf32) errs by 0.3-1.0 x K4_ATOL at unit norm
# over long masks, where the means average its error out, and by 12-16 x
# at norm 2 over 1-4 valid tokens a row (K4_SHORT_SHAPES), on an H100.
K4_ATOL = 2e-5
K4_SHAPES = ((1, 256, 128, 512), (4, 256, 320, 512), (16, 64, 32, 2048),
             (64, 1024, 256, 192), (5, 300, 77, 333))    # (Ba, Bb, TA, TB)
K4_SHORT_SHAPES = ((8, 256, 64, 192), (1, 256, 128, 512))
K4_SHORT_SCALE = 2.0
K4_EMPTY_SHAPES = ((1, 256, 128, 512),)  # a query with no valid token
# four queries, the /topk shape and one full block of the ragged scorer
K4_TIME_SHAPES = ((4, 256, 128, 512), (1, 256, 128, 512), (64, 1024, 256, 256))
FILIP_D = 128
FILIP_COSINE_MIN = 0.99
H100_BF16_FLOPS = 989e12              # dense tensor-core peak, SXM, 700 W
H100_F32_FLOPS = 67e12                # f32 on the CUDA cores (no tensor cores), SXM
H100_TF32_FLOPS = 495e12              # dense tensor-core peak, SXM, 700 W
H100_BYTES_PER_S = 3.35e12
H100_INT8_OPS = 1979e12               # dense tensor-core peak, SXM, 700 W
KERNELS = ("attention_fwd", "attention_bwd", "attention_fwd_f32", "attention_bwd_f32",
           "filip_maxsim", "infonce", "dense_mm", "ffn_gelu", "ffn_gelu_f32")
F32_KERNELS = ("attention_fwd_f32", "attention_bwd_f32")
# K1-f32 and K5-f32 against their plain versions, all f32 (TF32 off): the
# same form as bf16's, |err| <= F32_ATOL_RMS * rms(ref) + F32_RTOL * |ref|.
# The kernels' products are 3xTF32 (each operand split into TF32 hi and lo,
# hi.lo + lo.hi + hi.hi summed in f32), the plain versions' exact f32; they
# differ by those products' roundings, the order of f32 sums (64-key tiles
# and an online max against one softmax), ex2.approx (2^-22 relative) and,
# in K5-f32, delta as dO . O against rowsum(P * dP): up to 9.1e-6 (K1-f32)
# and 1.35e-5 (K5-f32) rms(ref) on an H100 over the 63 f32 cases, where
# the FFMA kernels they replaced read up to 3.2e-5. The limit is 2^-12
# (2.4e-4); the planted faults miss whole tiles, which moves outputs by
# O(rms(ref)), and plain TF32 (one product, attention_f32_tf32) reads
# 4e-3 to 6e-2 rms(ref) (tools/probe_attention_f32.py) and fails every
# case, K1-f32's by up to 57.3 times the limit (20.7 times at least on the
# packed unfrozen path's chunks). A query whose segment is one token long
# has O = v and dq = dk = 0 exactly in the plain version, which rms(ref)
# cannot scale; the kernels give them exactly (K1-f32 copies v for a query
# with one allowed key; K5-f32 gives such a query dq = 0 and dS = 0,
# attention_bwd_f32.cu), and the cases with such segments, T = 1
# included, hold it.
F32_ATOL_RMS, F32_RTOL = 2 ** -12, 2 ** -12
# f32 serving (K1-f32) against eager f32 attention on the same weights, per
# row: the two differ by f32 sums in another order (and at pad rows, which
# pooling drops).
F32_COSINE_MIN = 1 - 1e-6
# The f32 packed finetune step through K1-f32/K5-f32 against the same step
# through K5-f32's plain version: per leaf max|g_kernel - g_plain| <=
# F32_FT_TOL max|g_plain|. No bf16 rounding flips here, only f32 sums in
# another order carried through 30 layers of backward: the key bias read
# 9.985e-07 of its largest entry on an H100 (the next leaves 7.6e-07 and
# 7.0e-07), against bf16's 2^-6 = 1.6e-02. The limit, 2^-16 (1.5e-05), was
# set after that reading; K5-f32 built to drop the last query tile of dk/dv
# reads 0.73 (the v bias), 48 000 times the limit.
F32_FT_TOL = 2 ** -16
# The gated f32 finetune step (K6-f32) holds every leaf to F32_FT_TOL of the
# gate-off step with the heads' FFN activation F32_SMOOTH_HEADS (one of
# CLIPConfig's); with the default ReLU heads it holds the loss. A ReLU input
# that sits within an f32 rounding of 0 flips its gradient path under any
# change of the wi product's roundings: on an H100 the step with wi in exact
# f32 summed in another order (cuBLAS over the two halves of H) read 9.99e-05
# of the heads' aa_ffn/blocks/w leaf against the gate off, as did K6-f32,
# and 2.1e-04 to 4.4e-04 in its variants: whole flips, the same with any
# product that is not cuBLAS's to the bit.
F32_SMOOTH_HEADS = "gelu"
# K2/K3 against their plain version, both f32 (3xTF32 products on the
# tensor cores against cuBLAS f32 and logsumexp: the same sums in another
# order, over up to 4096 terms): |loss - ref| <= 1e-5 max(1, |ref|),
# |grad - ref| <= 1e-5 max|ref|. The planted faults (plain TF32; a
# cross-block sum that drops the last, partial tile) fail it.
INFONCE_RTOL = 1e-5
K2_POOLS, K3_POOLS = (16, 100, 256, 512), (1000, 1024, 2048, 4096)
DISPATCH_POOLS = (16, 128, 256, 384, 512, 1024, 2048)    # K2 and K3 timed side by side
FIXTURE_FAMILIES = 3000
TRAIN_LR = 1e-3
LORA_RANK = 8
# K5 at (B, T): the finetune chunks at the fixture's pep and rec buckets, K1's
# timing shape, odd T and a long row
K5_SHAPES = ((16, 32), (16, 192), (16, 512), (1, 1), (3, 63), (2, 200), (1, 2048), (3, 65),
             (3, 127), (3, 128), (3, 129))
K5_TIME_SHAPES = ((16, 512), (16, 192), (16, 32))
# The finetune step through K1/K5 against the same step through K1 and K5's
# plain version: per leaf max|g_kernel - g_plain| <= FT_K5_TOL max|g_plain|,
# the loss within FT_LOSS_TOL relative. Every backbone gradient passes
# through bf16 at each layer, so K5's sum order shows as bf16 rounding
# flips: one bf16 ulp (2^-8) in L2 at the median leaf, 2.6 ulps of the
# leaf's largest entry at the key bias, whose gradient nearly cancels
# (softmax ignores a per-query constant; RoPE leaves a remainder). The
# limit is four ulps; a K5 whose dk/dv loop drops the last query tile
# moves that leaf by 59 times it and every attention leaf by 34 or more.
FT_LOSS_TOL, FT_K5_TOL = 1e-6, 2 ** -6
# The same step against eager autograd, both bf16: per leaf |g_kernel -
# g_eager| <= 2 |g_eager - g_f32| + FT_GRAD_FLOOR max|g_f32| (and the loss
# alike, with FT_LOSS_FLOOR |loss_f32|, 1/40 of a bf16 ulp), with the eager
# step in f32 as the reference.
FT_LOSS_FLOOR, FT_GRAD_FLOOR = 1e-4, 1e-2
# P1: the probe's shape and t30_150M's linear layers (K, M) = q/k/v/o, wi, wo
# at serving and training token counts. s8 -> s32 is exact: equal to its
# plain version to the bit. bf16 -> f32: the same f32 products summed in
# another order, |err| <= MM_BF16_TOL (|x| @ |w|), the scale of a sum's
# rounding error.
T30_LAYERS = ((640, 640), (640, 2560), (2560, 640))
P1_SHAPES = ((8192, 2560, 2560),) + tuple((n, k, m) for n in (1, 128, 1000, 3072, 10240)
                                          for k, m in T30_LAYERS)
P1_BF16_SHAPES = ((8192, 2560, 2560), (1000, 2560, 640), (1, 640, 640)) + tuple(
    (n, k, m) for n in (128, 10240) for k, m in T30_LAYERS)
# The main loop's edges (csrc/mma_gemm.cuh), as (N, K, M) for s8: N around
# its 64- and 256-row blocks; K below, at and past one 128-byte ring stage
# (32, 128, 160 s8); M = 8 and M no multiple of its blocks' 64 or 128
# columns. bf16 P1 and K6 take K // 2 (16, 64, 80).
EDGE_SHAPES = tuple((n, k, m) for n in (1, 127, 129) for k, m in ((32, 8), (128, 200), (160, 72)))
MM_BF16_TOL = 1e-5
# K6 against its plain version, both bf16 out, at t30_150M's wi (H = 640, M
# = 2560): every output within FFN_ULPS bf16 ulps of max(|x @ w|, |b|,
# |ref|), and at most FFN_SHARE of them differ at all. The kernel's f32 sums
# run in another order, which flips the bf16 rounding of x @ w in about 2e-5
# of the outputs (emulated on the CPU: by up to 3 such ulps where the bias
# nearly cancels); a kernel that skips the rounding before the bias, or adds
# the bias without rounding the sum, changes 23-26% of them.
K6_ROWS = (64, 128, 3072, 10240)
FFN_ULPS, FFN_SHARE = 4, 1e-3
# K6-f32 (ffn_gelu_f32) against its plain version, both f32 (TF32 off), in
# K1-f32's form: |err| <= F32_ATOL_RMS * rms(ref) + F32_RTOL * |ref|. The
# kernel's products are 3xTF32 (each operand split into TF32 hi and lo,
# hi.hi + hi.lo + lo.hi; lo.lo, 2^-22 relative, left out), each k-tile's
# sum promoted to f32 registers, in another order than cuBLAS's f32 GEMM;
# and erff against torch's erf. The limit was set for the FFMA kernel this
# one replaced (up to 2.7e-5 of rms(ref)); 3xTF32 reads up to 2.6e-5 on
# an H100 (the most at H = 5120), 0.042 of the limit (tools/probe_ffn_f32.py),
# and 0.008 of it in the CPU emulation (tests/test_torch_ffn_f32.py).
# A main loop that drops its last k-tile of 32 moves an output by about
# sqrt(32 / H) of rms(ref), and plain TF32 (one product) by about 1e-3
# relative (4.4-4.8 times the limit in the emulation at 256 tokens): both
# past the limit.
# Cases: t30_150M's wi at K6_ROWS tokens, erf and tanh; the edges
# (EDGE_SHAPES, and K6_F32_EDGES where the large 128 x 128 tile runs with a
# partial last row and column tile); each family's wi (FFN_WIDTHS: t6_8M,
# t12_35M, t30_150M, t33_650M, t36_3B, t48_15B) at K6_F32_FAMILY_ROWS.
FFN_WIDTHS = ((320, 1280), (480, 1920), (640, 2560), (1280, 5120), (2560, 10240),
              (5120, 20480))
K6_F32_FAMILY_ROWS = (128, 3072)
K6_F32_EDGES = ((3073, 640, 2568), (1031, 1280, 5128))
# The gated f32 frozen step's loss against the gate-off step's (relative)
K6_F32_STEP_LOSS_TOL = 1e-5
# The planted faults, each a patched copy of csrc/ built under
# _build/fault/<name>/ and never loaded by the package: P1, K6 and K6-f32's
# shared main loop (csrc/mma_gemm.cuh) drops its last k-tile (main_loop;
# K6-f32's build of it is also ffn_f32_k_tile, built once), and K6-f32 drops
# its two correction products (plain TF32, ffn_f32_tf32); K1's key loop and
# K5's dk/dv query loop (csrc/attention.cuh) drop their last tile; the
# attention kernels' skip predicate misses a pair of tiles whose segment
# ranges meet at one id (the query tile's smallest, the key tile's largest);
# K4's b-tile skip predicate (csrc/filip_maxsim.cu) misses the tile's first
# token, and K4 drops its two correction products (plain TF32), as do
# K1-f32 and K5-f32 (attention_f32_tf32); K2 and K3
# (csrc/infonce.cu) drop theirs, and their cross-block sums of the forward's
# partials leave out the last tile when it is partial (B / 64 tiles).
FAULT_LINE = "  const int n_tiles = (K * Op::kEltBytes + kTileBytes - 1) / kTileBytes;"
SWEEP_FAULT_LINE = "  return (T + kTile - 1) / kTile;"
SKIP_FAULT_LINE = "  return q.x <= k.y && k.x <= q.y;"
MAXSIM_SKIP_LINE = ("          if (!__any_sync(0xffffffffu, (mbv.x | mbv.y) != 0)) continue;  "
                    "// an empty b-tile")
MAXSIM_TF32_LINE = "constexpr int kProducts = 3;  // TF32 products per k-step: hi.hi, hi.lo, lo.hi"
INFONCE_PARTIAL_LINE = ("__device__ __forceinline__ int summed_tiles(int B) "
                        "{ return tiles_of(B); }")
FAULTS = {   # name: (header, line, patched line, kernels built)
    "main_loop": ("mma_gemm.cuh", FAULT_LINE, FAULT_LINE[:-1] + " - 1;",
                  ("dense_mm", "ffn_gelu", "ffn_gelu_f32")),
    "ffn_f32_k_tile": ("mma_gemm.cuh", FAULT_LINE, FAULT_LINE[:-1] + " - 1;", ("ffn_gelu_f32",)),
    "ffn_f32_tf32": ("mma_gemm.cuh", MAXSIM_TF32_LINE, MAXSIM_TF32_LINE.replace("3;", "1;"),
                     ("ffn_gelu_f32",)),
    "swept_tiles": ("attention.cuh", SWEEP_FAULT_LINE, SWEEP_FAULT_LINE[:-1] + " - 1;",
                    ("attention_fwd", "attention_bwd", *F32_KERNELS)),
    "skip": ("attention.cuh", SKIP_FAULT_LINE, SKIP_FAULT_LINE.replace("q.x <=", "q.x <"),
             ("attention_fwd", "attention_bwd", *F32_KERNELS)),
    "attention_f32_tf32": ("attention_f32.cuh", MAXSIM_TF32_LINE,
                           MAXSIM_TF32_LINE.replace("3;", "1;"), F32_KERNELS),
    "maxsim_skip": ("filip_maxsim.cu", MAXSIM_SKIP_LINE,
                    MAXSIM_SKIP_LINE.replace("(mbv.x | mbv.y)", "((lane ? mbv.x : 0) | mbv.y)"),
                    ("filip_maxsim",)),
    "maxsim_tf32": ("filip_maxsim.cu", MAXSIM_TF32_LINE, MAXSIM_TF32_LINE.replace("3;", "1;"),
                    ("filip_maxsim",)),
    "infonce_tf32": ("infonce.cu", MAXSIM_TF32_LINE, MAXSIM_TF32_LINE.replace("3;", "1;"),
                     ("infonce",)),
    "infonce_partial": ("infonce.cu", INFONCE_PARTIAL_LINE,
                        INFONCE_PARTIAL_LINE.replace("tiles_of(B)", "B / kTile"), ("infonce",)),
}
FAULT_DIR = build.BUILD_ROOT / "fault"
# ESM-2 t33_650M (33 layers, hidden 1280, 20 heads of 64): served, trained
# packed (frozen and finetune) on the smaller fixture, its step checks at a
# global batch of 32 (the plain attention's (B, NH, T, T) f32 tensors of 33
# layers fit beside the step there).
T33 = "t33_650M"
T33_ATTENTION = (20, 64)              # its NH and DH
T33_CHECK_BATCH = 32
# The other families through esm2.forward: (family, layers; None: full depth)
FAMILY_RUNS = (("t6_8M", None), ("t12_35M", None), ("t36_3B", 2), ("t48_15B", 2))
# The smaller fixture: 1100 families give 770 train pairs, three steps at
# global batch 256, and 20 eval batches of 16. The packed unfrozen runs,
# the int8 run, the t33_650M runs and the f32 runs train on it.
SMALL_FIXTURE_FAMILIES = INT8_FIXTURE_FAMILIES = 1100
SMALL_DATA = "small_data"
# The one-bucket finetune and LoRA runs (8 s a step on an H100) train on
# 1000 families: two steps at global batch 256, one step interval to time.
ONE_BUCKET_FIXTURE_FAMILIES = 1000
ONE_BUCKET_DATA = "one_bucket_data"
# int8 against bf16 served embeddings, per row (no JAX reading at t30_150M:
# the sandbox that holds JAX runs no full-size model).
INT8_COSINE_MIN = 0.99
# FILIP training: cli.main_2protein_filip at its defaults (batch 10, one pad
# bucket) and at its documented scale-up with DCL, on a fixture of 1100
# families (770 train pairs: 77 and 6 steps).
FILIP_FIXTURE_FAMILIES = 1100
FILIP_RUNS = (("filip_10", []),
              ("filip_128", ["--batch-size", "128", "--num-chunks", "8", "--length-groups", "4",
                             "--use-dcl"]))
# The rest of FILIP training on the same fixture (phase 7b): packed at the
# documented scale-up (batch 128, 4 scatter tiers, the CLI's default, and 1),
# and the unfrozen modes at batch 64 in 2 chunks (12 steps), one bucket and
# packed; each with its engine, whose steps are timed.
FILIP_MORE_RUNS = (
    ("filip_packed_128", ["--batch-size", "128", "--packed"], filip_engine),
    ("filip_packed_128_flat", ["--batch-size", "128", "--packed", "--scatter-tiers", "1"],
     filip_engine),
    ("filip_finetune", ["--batch-size", "64", "--num-chunks", "2", "--finetune"], filip_finetune),
    ("filip_lora", ["--batch-size", "64", "--num-chunks", "2", "--lora-rank", str(LORA_RANK)],
     filip_lora),
    ("filip_finetune_packed", ["--batch-size", "64", "--finetune", "--packed"], filip_finetune),
    ("filip_lora_packed", ["--batch-size", "64", "--lora-rank", str(LORA_RANK), "--packed"],
     filip_lora))
# The FILIP finetune step check's global batch: the CLIP finetune step
# check (FT_K5_TOL) runs at 256; in chunks of 32 pairs here.
FILIP_FT_CHECK_BATCH = 256
# The FILIP finetune step through K1/K5 against the same step through K1
# and K5's plain version, check_finetune_step's form: per leaf max|g_kernel
# - g_plain| <= FILIP_FT_K5_TOL max|g_plain|. FT_K5_TOL does not hold
# there: on an H100 the token embedding table and the q and k weights read
# 1.26-1.64 of it (batch 256 and 64, one bucket and packed). FILIP's
# cotangent reaches each row only through its max-sim tokens, so a leaf's
# largest entry sums fewer terms than under pooled CLIP, and the same bf16
# rounding flips of K5's sums weigh more against it; either bf16 step sits
# 8-27 FT_K5_TOL from the step with eager attention in f32. The limit is
# four times FT_K5_TOL, set after those readings; a K5 whose dk/dv loop
# drops the last query tile reads 51-71 times FT_K5_TOL.
FILIP_FT_K5_TOL = 4 * FT_K5_TOL
# The max-sim backward (plain PyTorch in f32) against autograd through
# maxsim_reference in float64, on tokens whose scores are exact in both: the
# same ties, so the gap is the f32 sums' rounding, about 1e-7 of the largest
# entry (CPU rehearsal); a split that misses one tied token is off by a
# share of the largest.
MAXSIM_BWD_RTOL = 1e-5
# The same on packed FILIP's tier-pair blocks, where a token's gradient sums
# up to 128 x 128 = 16 384 terms: the f32 sums read up to 1.35e-5 of the
# largest entry on an H100, 1.7 sqrt(16 384) f32 roundings (2^-24). The
# limit is 5 sqrt(16 384) of them, set after those readings; a backward
# that gives each tied token the whole gradient of its max, instead of an
# even share, must fail it.
MAXSIM_TIER_BWD_RTOL = 5 * 128 * 2 ** -24
# One FILIP step through K4 against the same step through its plain
# version: the loss within FILIP_STEP_TOL relative, each head gradient
# within FILIP_STEP_TOL of the step's largest gradient entry (K4's scores
# are within K4_ATOL of the plain ones, and the backward is the same code).
FILIP_STEP_TOL = 1e-5
AAS = "LAGVSERTIDPKQNFYMHWC"


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(what: str, fn, *args, **kwargs):
    """fn(*args, **kwargs), its seconds printed as a [timing] line."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"[timing] {what}: {time.perf_counter() - t0:.1f} s")
    return out


def profiled_step(step) -> tuple[list, float]:
    """One call of ``step()`` under torch.profiler, CUDA activity only (a
    step's CPU operator trace, some 10^5 events, takes the profiler tens of
    seconds to parse): (the kernels' averages that ran on the card, the
    call's wall seconds)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0], wall


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over iters calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def qkv(B: int, T: int, gen: torch.Generator, nh: int = NH, dh: int = DH,
        dtype: torch.dtype = torch.bfloat16):
    def r(scale):
        return (scale * torch.randn(B, T, nh, dh, device="cuda", generator=gen)).to(dtype)
    return r(dh ** -0.5), r(1.0), r(1.0)


def tolerance(dtype: torch.dtype) -> tuple[float, float]:
    """(atol in rms(ref) units, rtol) of the attention checks in ``dtype``."""
    return (F32_ATOL_RMS, F32_RTOL) if dtype == torch.float32 else (ATOL_RMS, RTOL)


def padded_segments(B: int, T: int) -> torch.Tensor:
    """0/1 masks with true lengths spread over (0, T]; every row but the
    longest ends in pad positions, whose query rows are fully masked."""
    lengths = np.linspace(max(1, T // 8), T, B).astype(int) if B > 1 else [T - T // 4]
    seg = torch.zeros(B, T, dtype=torch.int32)
    for b, n in enumerate(lengths):
        seg[b, :n] = 1
    return seg.cuda()


def packed_segments(B: int, T: int) -> torch.Tensor:
    """Packed rows: segments 1, 2, 3, ... of varied length with gap zeros."""
    rng = np.random.default_rng(SEED)
    seg = torch.zeros(B, T, dtype=torch.int32)
    for b in range(B):
        pos, sid = 0, 1
        while pos < T - 8:
            n = int(rng.integers(8, max(9, T // 3)))
            seg[b, pos:min(T, pos + n)] = sid
            pos += n + int(rng.integers(0, 5))   # gap of 0-4 zeros
            sid += 1
    return seg.cuda()


def one_token_segments(B: int, T: int) -> torch.Tensor:
    """Packed rows whose segments are one token long every other time
    (lengths 1 and 2-9 in turn, gap zeros between some)."""
    rng = np.random.default_rng(SEED)
    seg = torch.zeros(B, T, dtype=torch.int32)
    for b in range(B):
        pos, sid = b % 2, 1
        while pos < T:
            n = 1 if sid % 2 else int(rng.integers(2, 10))
            seg[b, pos:min(T, pos + n)] = sid
            pos += n + int(rng.integers(0, 2))   # gap of 0-1 zeros
            sid += 1
    return seg.cuda()


def short_segments(B: int, T: int) -> torch.Tensor:
    """Packed rows of segments of 2-8 tokens with a gap zero between some:
    each query averages over a few keys, so a product's rounding of P and v
    is not averaged away."""
    rng = np.random.default_rng(SEED + 1)
    seg = torch.zeros(B, T, dtype=torch.int32)
    for b in range(B):
        pos, sid = 0, 1
        while pos < T:
            n = int(rng.integers(2, 9))
            seg[b, pos:min(T, pos + n)] = sid
            pos += n + int(rng.integers(0, 2))   # gap of 0-1 zeros
            sid += 1
    return seg.cuda()


def path_segments(family: str = "t30_150M") -> list[tuple[str, bool, torch.Tensor]]:
    """(kind, on the packed unfrozen path, segment ids) of the chunks K1 and
    K5 take on the packed paths, as derive_segments gives them: the last
    chunk of each side of ``cli.main --packed``'s first global batch on the
    fixture (pep (16, 128), rec (16, 256): rows of 2-11 segments, each with
    one gap at its end, and the all-<pad> rows that _row_multiple_for adds,
    which these chunks hold; it raises if they do not); the last pep chunk
    of ``cli.main --packed --finetune``'s first batch ((48, 128): the
    unfrozen step's constant-token rule; that run trains on the smaller
    fixture); and the last receptor chunk of tools/bench_train's first
    standard draw ((16, 512)) and of its second long-tail draw ((28, 2048)),
    rows packed first-fit-decreasing from bench.py's length draws. The rec
    (16, 256) chunk is on both paths. For t33_650M, the chunks of its runs
    (run_t33_train_phase): the same three of the first batch on the smaller
    fixture."""

    def first_batch(data_dir, families):
        if not (data_dir / "receptor.fasta").exists():
            write_fixture(data_dir, n_families=families, seed=42)
        train, _, _ = epoch_loaders(data_dir)
        return packed_engine.tokenize_packed(common.make_tokenizer(),
                                             *next(clip_engine._accumulate(train, 16)))

    small = first_batch(WORK / SMALL_DATA, SMALL_FIXTURE_FAMILIES)
    fixture = small if family == T33 else first_batch(WORK / "train_data", FIXTURE_FAMILIES)
    draws = () if family == T33 else (
        ("bench_train standard draw 1",
         bench_train.make_batches(np.random.default_rng(42), 1, "standard")[0]),
        ("bench_train long-tail draw 2",
         bench_train.make_batches(np.random.default_rng(42), 2, "longtail")[1]))
    out = []

    def last_chunk(what, path, batch, side, rows, pads_needed=False):
        seg = packed_engine.derive_segments(batch[f"{side}_ids"].cuda())[1]
        chunk = seg[-rows:].contiguous()
        pad_rows = int((chunk.amax(1) == 0).sum())
        if pads_needed and not pad_rows:
            raise AssertionError(f"the last {side} chunk {tuple(chunk.shape)} has no <pad> row")
        out.append((f"packed, {what} {side} chunk, {pad_rows} rows all <pad>", path, chunk))

    run = "cli.main" if family != T33 else f"cli.main --esm-config {T33}"
    for side in ("pep", "rec"):
        last_chunk(f"{run} --packed", side == "rec", fixture, side,
                   chunk_rows(fixture[f"{side}_ids"].shape[0]), pads_needed=True)
    last_chunk(f"{run} --packed --finetune", True, small, "pep",
               unfrozen_chunk_shapes(small)[0][0])
    for what, batch in draws:
        last_chunk(what, True, batch, "rec", unfrozen_chunk_shapes(batch)[1][0])
    return out


def family_segments() -> list[tuple[int, int, str, torch.Tensor]]:
    """(NH, DH, kind, segments) of the other families' cases (FAMILY_SHAPES):
    padded, padded with a row of no valid token, packed, and at odd T."""
    out = []
    for B, T, nh, dh in FAMILY_SHAPES:
        fully = padded_segments(B, T)
        fully[B // 2] = 0
        out += [(nh, dh, "padded", padded_segments(B, T)),
                (nh, dh, "padded, one row fully padded", fully),
                (nh, dh, "packed", packed_segments(B, T)),
                (nh, dh, "padded", padded_segments(3, 65)),
                (nh, dh, "packed", packed_segments(3, 129))]
    return out


def attention_cases(gen: torch.Generator, segments: list, t33_segments: list) -> list:
    """(B, T, kind, on the unfrozen path, q, k, v, segments) for K1: padded
    rows (fully padded query rows included) at KERNEL_SHAPES, synthetic
    packed rows at three shapes, and the packed paths' own ``segments``
    (path_segments), at t30_150M's NH 20 and DH 32; t33_650M's packed
    chunks (``t33_segments``) at its NH 20 and DH 64; then the other
    families' (family_segments)."""
    cases = [(B, T, "padded", False, padded_segments(B, T)) for B, T in KERNEL_SHAPES]
    cases += [(4, 512, "packed", False, packed_segments(4, 512)),
              (2, 129, "packed", False, packed_segments(2, 129)),
              (1, 2048, "packed", False, packed_segments(1, 2048))]
    cases += [(*seg.shape, kind, path, seg) for kind, path, seg in segments]
    out = [(B, T, kind, path, *qkv(B, T, gen), seg) for B, T, kind, path, seg in cases]
    out += [(*seg.shape, kind, path, *qkv(*seg.shape, gen, *T33_ATTENTION), seg)
            for kind, path, seg in t33_segments]
    return out + [(*seg.shape, kind, False, *qkv(*seg.shape, gen, nh, dh), seg)
                  for nh, dh, kind, seg in family_segments()]


SHORT_KIND = "packed, 2-8-token segments"
# rows of one 64-query tile (T <= 64): a block's second warpgroup idle,
# several allowed keys a query
ONE_TILE_KINDS = ("one tile, padded", "one tile, 2-8-token segments")


def f32_segments(segments: list) -> list[tuple[int, int, str, bool, torch.Tensor]]:
    """(NH, DH, kind, on the unfrozen path, segments) of the f32 cases:
    (16, 512) padded with a row of no valid token, odd T padded and packed,
    and the packed paths' chunks (path_segments: the fixture's, and
    tools/bench_train's (16, 512) and (28, 2048) receptor chunks of rows
    packed first-fit-decreasing from bench.py's length draws) at
    t30_150M's NH 20 and DH 32; then each family's head dim
    (family_segments); then at every head dim, rows with one-token
    segments (one_token_segments) at (3, 129), at T = 1 with a pad row
    among them, segments of 2-8 tokens (short_segments) at (4, 256),
    where plain TF32 fails, and rows of one tile (ONE_TILE_KINDS): the
    finetune chunk's (16, 32) padded and 2-8-token segments at (4, 40)."""
    fully = padded_segments(16, 512)
    fully[8] = 0
    out = [(NH, DH, "padded, one row fully padded", False, fully),
           (NH, DH, "padded", False, padded_segments(3, 65)),
           (NH, DH, "packed", False, packed_segments(2, 129))]
    out += [(NH, DH, kind, path, seg) for kind, path, seg in segments]
    out += [(nh, dh, kind, False, seg) for nh, dh, kind, seg in family_segments()]
    for nh, dh in dict.fromkeys([(NH, DH)] + [(nh, dh) for _, _, nh, dh in FAMILY_SHAPES]):
        t1 = torch.tensor([[1], [1], [0], [3]], dtype=torch.int32, device="cuda")
        out += [(nh, dh, "packed, one-token segments", False, one_token_segments(3, 129)),
                (nh, dh, "T = 1, one pad row", False, t1),
                (nh, dh, SHORT_KIND, False, short_segments(4, 256)),
                (nh, dh, ONE_TILE_KINDS[0], False, padded_segments(16, 32)),
                (nh, dh, ONE_TILE_KINDS[1], False, short_segments(4, 40))]
    return out


def attention_cases_f32(gen: torch.Generator, segments: list) -> list:
    """K1-f32's cases, in attention_cases' form, on f32 q, k, v
    (f32_segments)."""
    return [(*seg.shape, kind, path, *qkv(*seg.shape, gen, nh, dh, torch.float32), seg)
            for nh, dh, kind, path, seg in f32_segments(segments)]


def bwd_cases_f32(gen: torch.Generator, segments: list) -> list:
    """K5-f32's cases, in bwd_cases' form, on f32 q, k, v and dO
    (f32_segments)."""
    out = []
    for nh, dh, kind, path, seg in f32_segments(segments):
        q, k, v = qkv(*seg.shape, gen, nh, dh, torch.float32)
        do = torch.randn(*seg.shape, nh, dh, device="cuda", generator=gen)
        out.append((*seg.shape, kind, path, q, k, v, do, seg))
    return out


def case_name(B: int, T: int, kind: str, q: torch.Tensor) -> str:
    dtype = " f32" if q.dtype == torch.float32 else ""
    return f"B={B} T={T} NH={q.shape[2]} DH={q.shape[3]}{dtype} {kind}"


def by_rows(fn, q, *tensors):
    """fn(q, *tensors) of an attention plain version, over slices of rows
    whose (rows, NH, T, T) f32 tensors hold at most 2^29 elements, the
    outputs concatenated: at (28, 2048) one such tensor is 9.4 GB."""
    T = q.shape[1]
    rows = max(1, 2 ** 29 // (q.shape[2] * T * T))
    if rows >= q.shape[0]:
        return fn(q, *tensors)
    parts = [fn(*(t[i:i + rows] for t in (q, *tensors))) for i in range(0, q.shape[0], rows)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def least_atol(got: torch.Tensor, want: torch.Tensor, rtol: float = RTOL,
               seg: torch.Tensor | None = None) -> tuple[float, float]:
    """(max|err|, the least atol in units of rms(want) that passes
    |err| <= atol + rtol |want|; inf where got is not finite). With
    ``seg`` ((B, T) segment ids of an attention output (B, T, ...)) the rms
    is that of the valid queries' outputs (seg > 0), where there are any."""
    w = want.float()
    err = (got.float() - w).abs()
    valid = w[seg > 0] if seg is not None and bool((seg > 0).any()) else w
    rms = valid.square().mean().sqrt().item()
    need = (err - rtol * w.abs()).max().item() / max(rms, 1e-30)
    return err.max().item(), need if bool(torch.isfinite(got).all()) else math.inf


def k1_readings(cases: list) -> list[dict]:
    """K1 on each case against attention_reference: the least passing atol
    (rms units) of the output, and its statistics' largest gap from
    attention_reference_lse (inf where a pad query's -inf is not matched)."""
    rows = []
    for B, T, kind, path, q, k, v, seg in cases:
        out, lse = attention._forward(q, k, v, seg, with_lse=True)
        torch.cuda.synchronize()
        atol, rtol = tolerance(q.dtype)
        err, need = least_atol(out, by_rows(attention.attention_reference, q, k, v, seg), rtol,
                               seg)
        want = by_rows(attention.attention_reference_lse, q, k, seg)
        pad = torch.isinf(want)
        lse_err = (float((lse[~pad] - want[~pad]).abs().max()) if bool((~pad).any()) else 0.0)
        if not torch.equal(torch.isinf(lse), pad):
            lse_err = math.inf
        rows.append({"case": case_name(B, T, kind, q), "dh": q.shape[3],
                     "packed": kind.startswith("packed"), "path": path, "max_abs_err": err,
                     "need": need, "atol": atol, "rtol": rtol, "lse_err": lse_err})
    return rows


def check_attention(cases: list, name: str = "attention_fwd") -> float:
    """K1 (or K1-f32, ``name``) against its plain version: every output
    within atol * rms(ref) + rtol |ref|, rms over the valid queries'
    outputs (ATOL_RMS and RTOL, in f32 F32_ATOL_RMS and F32_RTOL), its
    statistics within LSE_ATOL of
    attention_reference_lse (and -inf at the same pad queries)."""
    worst = 0.0
    for row in k1_readings(cases):
        ok = row["need"] <= row["atol"] and row["lse_err"] <= LSE_ATOL
        worst = max(worst, row["max_abs_err"])
        log(f"[kernels] {name} {row['case']}: max|err| {row['max_abs_err']:.6g}; "
            f"least passing atol {row['need']:.6g} rms(ref) (tolerance {row['atol']:g} rms(ref) "
            f"+ {row['rtol']:g}*|ref|); lse max|err| {row['lse_err']:.3g} (tolerance "
            f"{LSE_ATOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version ({row['case']})")
    return worst


def bwd_cases(gen: torch.Generator, segments: list, t33_segments: list) -> list:
    """(B, T, kind, on the unfrozen path, q, k, v, dO, segments) for K5:
    padded rows everywhere (with one row of no valid token where B > 1,
    whose queries are all uniform), synthetic packed rows at three shapes,
    and the chunks of ``segments`` (path_segments) on the packed unfrozen
    path, at t30_150M's NH 20 and DH 32; those of ``t33_segments`` at
    t33_650M's NH 20 and DH 64; then the other families'
    (family_segments)."""
    cases = []
    for B, T in K5_SHAPES:
        kinds = ["padded"] + (["packed"] if T in (192, 200, 2048) else [])
        for kind in kinds:
            if kind == "packed":
                seg = packed_segments(B, T)
            else:
                seg = padded_segments(B, T)
                if B > 1:
                    seg[B // 2] = 0
                    kind = "padded, one row fully padded"
            cases.append((B, T, kind, False, seg))
    cases = [(NH, DH, *case) for case in cases]
    cases += [(NH, DH, *seg.shape, kind, True, seg) for kind, path, seg in segments if path]
    cases += [(*T33_ATTENTION, *seg.shape, kind, True, seg)
              for kind, path, seg in t33_segments if path]
    cases += [(nh, dh, *seg.shape, kind, False, seg) for nh, dh, kind, seg in family_segments()]
    out = []
    for nh, dh, B, T, kind, path, seg in cases:
        q, k, v = qkv(B, T, gen, nh, dh)
        do = torch.randn(B, T, nh, dh, device="cuda", generator=gen).bfloat16()
        out.append((B, T, kind, path, q, k, v, do, seg))
    return out


def k5_readings(cases: list) -> list[dict]:
    """K5, fed K1's statistics, on each case against
    attention_reference_bwd: the least passing atol (rms units) of dq, dk
    and dv."""
    rows = []
    for B, T, kind, path, q, k, v, do, seg in cases:
        out, lse = attention._forward(q, k, v, seg, with_lse=True)
        got = attention.fused_attention_bwd(q, k, v, seg, do, lse, out)
        torch.cuda.synchronize()
        want = by_rows(attention.attention_reference_bwd, q, k, v, seg, do)
        atol, rtol = tolerance(q.dtype)
        errs = [least_atol(g, w, rtol) for g, w in zip(got, want)]
        rows.append({"case": case_name(B, T, kind, q), "dh": q.shape[3],
                     "packed": kind.startswith("packed"), "path": path,
                     "max_abs_err": max(e for e, _ in errs), "atol": atol, "rtol": rtol,
                     "needs": dict(zip(("dq", "dk", "dv"), (n for _, n in errs)))})
    return rows


def check_attention_bwd(cases: list, name: str = "attention_bwd") -> float:
    """K5 (or K5-f32, ``name``) against attention_reference_bwd, each of
    dq, dk, dv held to K1's form |err| <= atol * rms(ref) + rtol * |ref|:
    in bf16 both round P and dS to bf16 for the products, from f32 values
    that differ by the order of their sums and by ex2.approx, and round the
    outputs to bf16 (2^-8 relative, within RTOL); in f32 F32_ATOL_RMS and
    F32_RTOL say why."""
    worst = 0.0
    for row in k5_readings(cases):
        ok = max(row["needs"].values()) <= row["atol"]
        worst = max(worst, row["max_abs_err"])
        log(f"[kernels] {name} {row['case']}: max|err| {row['max_abs_err']:.6g}; "
            f"least passing atol " + ", ".join(f"{k} {v:.6g}" for k, v in row["needs"].items())
            + f" rms(ref) (tolerance {row['atol']:g} rms(ref) + {row['rtol']:g}*|ref|) "
            + ("ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version ({row['case']})")
    return worst


def maxsim_inputs(Ba: int, Bb: int, TA: int, TB: int, gen: torch.Generator,
                  scale: float = 1.0, short: bool = False, empty_a: bool = False):
    """f32 tokens of norm `scale` and padded 0/1 masks, true lengths over
    [T/4, T] (short: [1, 4]); when Ba > 1 one a-row (empty_a: every a-row),
    and always one b-row, has no valid token (the clamp path); when TB > 64,
    b-row 0 holds 65 valid tokens, so its second tile's only valid token is
    its first."""
    def tokens(B, T):
        x = torch.randn(B, T, FILIP_D, device="cuda", generator=gen)
        return scale * torch.nn.functional.normalize(x, dim=-1)

    def mask(B, T):
        lo, hi = (1, min(4, T)) if short else (max(1, T // 4), T)
        lengths = torch.randint(lo, hi + 1, (B, 1), device="cuda", generator=gen)
        return (torch.arange(T, device="cuda")[None, :] < lengths).to(torch.int32)

    ma, mb = mask(Ba, TA), mask(Bb, TB)
    if TB > 64 and Bb > 1:
        mb[0] = 0
        mb[0, :65] = 1
    if Ba > 1:
        ma[Ba // 2] = 0
    if empty_a:
        ma[:] = 0
    mb[Bb // 2] = 0
    return tokens(Ba, TA), tokens(Bb, TB), ma, mb


def maxsim_cases(gen: torch.Generator) -> list:
    """K4's check inputs: K4_SHAPES at unit norm, K4_SHORT_SHAPES short, and
    a query with no valid token at the /topk grid (K4_EMPTY_SHAPES)."""
    return ([(shape, maxsim_inputs(*shape, gen)) for shape in K4_SHAPES]
            + [(shape, maxsim_inputs(*shape, gen, K4_SHORT_SCALE, short=True))
               for shape in K4_SHORT_SHAPES]
            + [(shape, maxsim_inputs(*shape, gen, empty_a=True))
               for shape in K4_EMPTY_SHAPES])


def one_token_tile(ma: torch.Tensor, mb: torch.Tensor) -> bool:
    """Whether a b-row holds a 64-token tile whose only valid token is its
    first, against an a-row with a valid token: what the planted skip fault
    misses."""
    tiles = torch.nn.functional.pad(mb != 0, (0, -mb.shape[1] % 64)).view(mb.shape[0], -1, 64)
    return bool((ma != 0).any()) and bool(((tiles.sum(-1) == 1) & tiles[..., 0]).any())


def k4_readings(cases: list) -> list[dict]:
    """Per case ((Ba, Bb, TA, TB), inputs[, label]): K4's largest gap from
    maxsim_reference over oa and ob, whether the outputs are finite and
    whether the rows with no valid token (an a-row's or a b-row's) score 0
    on both outputs."""
    rows = []
    for (Ba, Bb, TA, TB), (ha, hb, ma, mb), *label in cases:
        got = maxsim.filip_similarity_fused(ha, hb, ma, mb, 1.0)
        torch.cuda.synchronize()
        want = maxsim.maxsim_reference(ha, hb, ma, mb)
        empty_a, empty_b = ma.sum(1) == 0, mb.sum(1) == 0
        empty_ok = all(bool((g[empty_a] == 0).all()) and bool((g[:, empty_b] == 0).all())
                       for g in got)
        rows.append({"shape": [Ba, Bb, TA, TB], "label": label[0] if label else "",
                     "short": 0 < int(ma.sum(1).max()) <= 4,
                     "empty_a": bool(empty_a.all()), "one_token_tile": one_token_tile(ma, mb),
                     "err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
                     "finite": all(bool(torch.isfinite(g).all()) for g in got),
                     "empty_ok": empty_ok})
    return rows


def check_maxsim(cases: list) -> float:
    rows = k4_readings(cases)
    for r in rows:
        ok = r["finite"] and r["err"] <= K4_ATOL and r["empty_ok"]
        log(f"[kernels] filip_maxsim {r['label'] + ' ' if r['label'] else ''}"
            f"(Ba, Bb, TA, TB)={tuple(r['shape'])} D={FILIP_D}"
            f"{f' norm {K4_SHORT_SCALE:g}, 1-4 valid tokens a row' if r['short'] else ''}"
            f"{', no valid a-token' if r['empty_a'] else ''}: "
            f"max|err| {r['err']:.6g} (tolerance {K4_ATOL:g}); empty rows score 0: "
            f"{r['empty_ok']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"filip_maxsim disagrees with its plain version at {r['shape']}")
    return max(r["err"] for r in rows)


@contextlib.contextmanager
def maxsim_kernel(lib: Path):
    """ops.filip launches the build ``lib`` while the block runs."""
    saved = maxsim._launcher
    faulty = maxsim.bind(ctypes.CDLL(str(lib)))
    maxsim._launcher = lambda: faulty
    try:
        yield
    finally:
        maxsim._launcher = saved


def check_maxsim_faults(libs: dict, cases: list, skip_must=None) -> dict:
    """K4's check against its two planted faults, on the same inputs: the
    skip fault must fail every case with a one-token tile (or those
    ``skip_must(reading)`` names), the plain-TF32 fault at least the short
    ones. Returns the worst ratio to K4_ATOL and the cases failed."""
    out = {}
    for name, what, must in (
            ("maxsim_skip", "b-tile skip predicate misses the tile's first token",
             skip_must or (lambda r: r["one_token_tile"])),
            ("maxsim_tf32", "plain TF32, the correction products dropped",
             lambda r: r["short"])):
        with maxsim_kernel(libs[name]["filip_maxsim"]):
            rows = k4_readings(cases)
        fails = [r["err"] > K4_ATOL or not r["empty_ok"] for r in rows]
        failed = [r for r, f in zip(rows, fails) if f]
        missed = [r["shape"] for r, f in zip(rows, fails) if must(r) and not f]
        out[name] = {"worst_ratio": max(r["err"] for r in rows) / K4_ATOL,
                     "cases_failed": len(failed), "cases": len(rows),
                     "ratios": [r["err"] / K4_ATOL for r in rows]}
        log(f"[kernels] planted fault {name} ({what}): filip_maxsim fails {len(failed)} of "
            f"{len(rows)} cases, at {', '.join(f'{x:.4g}' for x in out[name]['ratios'])} x "
            f"its tolerance; cases it should fail and passes: {missed or 'none'}")
        if missed:
            raise AssertionError(f"the filip_maxsim check does not see the planted fault {name}")
    return out


def unit_rows(B: int, D: int, t: float, gen: torch.Generator):
    """(B, D) f32 x, y: unit rows scaled by exp(t/2), as the heads give them."""
    def rows():
        x = torch.randn(B, D, device="cuda", generator=gen)
        return (torch.nn.functional.normalize(x, dim=-1) * math.exp(t / 2)).contiguous()
    return rows(), rows()


def value_and_grads(fn, x, y):
    xr, yr = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    loss = fn(xr, yr)
    loss.backward()
    torch.cuda.synchronize()
    return loss.detach(), xr.grad, yr.grad


def infonce_cases(gen: torch.Generator) -> list:
    """(kernel, B, D, t, x, y) of the K2 and K3 checks: unit rows scaled by
    exp(t/2) at the pools of K2_POOLS and K3_POOLS, D = 128, and D = 64 once
    each."""
    cases = [("infonce", B, 128, t) for B in K2_POOLS for t in (1.0, 4.0)]
    cases += [("infonce_tiled", B, 128, t) for B in K3_POOLS for t in (1.0, 4.0)]
    cases += [("infonce", 256, 64, 1.0), ("infonce_tiled", 1024, 64, 1.0)]
    return [(name, B, D, t, *unit_rows(B, D, t, gen)) for name, B, D, t in cases]


def infonce_readings(cases: list) -> list[dict]:
    """Each case through its kernel and through clip_infonce, forward and
    backward: the errors (loss, dX, dY), their tolerances and the largest
    ratio of one to the other."""
    rows = []
    for name, B, D, t, x, y in cases:
        fn = infonce.fused_infonce if name == "infonce" else infonce.fused_infonce_tiled
        got = value_and_grads(fn, x, y)
        want = value_and_grads(infonce.clip_infonce, x, y)
        errs = [abs(float(got[0] - want[0]))]
        errs += [float((g - w).abs().max()) for g, w in zip(got[1:], want[1:])]
        tols = [INFONCE_RTOL * max(1.0, abs(float(want[0])))]
        tols += [INFONCE_RTOL * float(w.abs().max()) for w in want[1:]]
        finite = all(bool(torch.isfinite(v).all()) for v in got)
        ratio = max(e / tol for e, tol in zip(errs, tols)) if finite else math.inf
        rows.append({"name": name, "case": f"{name} B={B} D={D} t={t:g}", "B": B, "t": t,
                     "loss": float(got[0]), "errs": errs, "tols": tols, "ratio": ratio})
    return rows


def check_infonce(cases: list) -> dict:
    """K2 and K3, forward and backward, against the plain clip_infonce;
    returns the largest absolute error of each (loss and gradients)."""
    worst = {"infonce": 0.0, "infonce_tiled": 0.0}
    for r in infonce_readings(cases):
        ok = r["ratio"] <= 1
        worst[r["name"]] = max(worst[r["name"]], *r["errs"])
        log(f"[kernels] {r['case']}: loss {r['loss']:.6f}, |err| {r['errs'][0]:.3g} "
            f"(tolerance {r['tols'][0]:.3g}); max|err| dX {r['errs'][1]:.3g}, dY "
            f"{r['errs'][2]:.3g} (tolerance {r['tols'][1]:.3g}, {r['tols'][2]:.3g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the kernel disagrees with its plain version: {r['case']}")
    return worst


@contextlib.contextmanager
def infonce_kernel(lib: Path):
    """ops.infonce launches the library at ``lib`` while the block runs."""
    saved = infonce._launchers
    faulty = infonce.bind(ctypes.CDLL(str(lib)))
    infonce._launchers = lambda: faulty
    try:
        yield
    finally:
        infonce._launchers = saved


def check_infonce_faults(libs: dict, cases: list) -> dict:
    """The K2 and K3 check against their two planted faults, on its own
    inputs: plain TF32 must fail every case at t = 4 (logits up to e^4,
    where TF32's three digits show; at t = 1 the kernels' centred products
    leave it near the tolerance), and the partial-tile fault every case
    whose pool is no multiple of 64 (B = 100, 1000). Returns the worst ratio
    to the tolerance, the cases failed and every case's ratio."""
    out = {}
    for name, what, must in (
            ("infonce_tf32", "plain TF32, the correction products dropped",
             lambda r: r["t"] == 4.0),
            ("infonce_partial", "the cross-block sums drop the last, partial tile",
             lambda r: r["B"] % 64 != 0)):
        with infonce_kernel(libs[name]["infonce"]):
            rows = infonce_readings(cases)
        ratios = {r["case"]: r["ratio"] for r in rows}
        failed = [c for c, x in ratios.items() if x > 1]
        missed = [r["case"] for r in rows if must(r) and r["ratio"] <= 1]
        out[name] = {"worst_ratio": max(ratios.values()), "cases_failed": len(failed),
                     "cases": len(rows), "ratios": ratios}
        log(f"[kernels] planted fault {name} ({what}): fails {len(failed)} of {len(rows)} "
            f"cases, at {', '.join(f'{c}: {x:.4g}' for c, x in ratios.items())} x its "
            f"tolerance; cases it should fail and passes: {missed or 'none'}")
        if missed:
            raise AssertionError(f"the infonce check does not see the planted fault {name}")
    return out


def s8_pair(N: int, K: int, M: int, gen: torch.Generator):
    return (torch.randint(-128, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8),
            torch.randint(-128, 128, (K, M), generator=gen, device="cuda", dtype=torch.int8))


def bf16_pair(N: int, K: int, M: int, gen: torch.Generator):
    return (torch.randn(N, K, generator=gen, device="cuda").bfloat16(),
            (torch.randn(K, M, generator=gen, device="cuda") / K ** 0.5).bfloat16())


def mm_bf16_gap(x: torch.Tensor, w: torch.Tensor, got: torch.Tensor) -> float:
    """max |got - plain| / (|x| @ |w|): the bf16 form's error on the scale
    of an f32 sum's rounding error."""
    want = dense_mm.mm_reference(x, w, torch.float32)
    scale = torch.matmul(x.float().abs(), w.float().abs()).clamp(min=1e-30)
    return float(((got - want).abs() / scale).max())


def check_dense_mm(gen: torch.Generator) -> dict:
    """P1 s8 against mm_reference to the bit at P1_SHAPES and at the extreme
    values, and bf16 -> f32 within MM_BF16_TOL at P1_BF16_SHAPES."""
    for N, K, M in P1_SHAPES:
        x, w = s8_pair(N, K, M, gen)
        got = dense_mm.mm(x, w, torch.int32)
        torch.cuda.synchronize()
        if not torch.equal(got, dense_mm.mm_reference(x, w, torch.int32)):
            raise AssertionError(f"dense_mm s8 differs from its plain version at {(N, K, M)}")
    for N, K, M in EDGE_SHAPES:
        x, w = s8_pair(N, K, M, gen)
        if not torch.equal(dense_mm.mm(x, w, torch.int32),
                           dense_mm.mm_reference(x, w, torch.int32)):
            raise AssertionError(f"dense_mm s8 differs from its plain version at the edge "
                                 f"{(N, K, M)}")
    log(f"[kernels] dense_mm s8 -> s32 equals its plain version to the bit at "
        f"{len(P1_SHAPES)} shapes: {P1_SHAPES}, and at {len(EDGE_SHAPES)} edges: {EDGE_SHAPES}")
    for value in (127, -127, -128):
        for N, K, M in ((130, 2560, 640), (1000, 640, 2560)):
            x = torch.full((N, K), value, dtype=torch.int8, device="cuda")
            x[1::3] = -128
            w = torch.full((K, M), value, dtype=torch.int8, device="cuda")
            w[:, 1::2] = 127
            want = dense_mm.mm_reference(x, w, torch.int32)
            if not torch.equal(dense_mm.mm(x, w, torch.int32), want):
                raise AssertionError(f"dense_mm s8 differs at the extreme {value}, {(N, K, M)}")
    log(f"[kernels] dense_mm s8 at the extremes (+127, -127, -128; sums up to "
        f"{2560 * 128 * 128}) equal to the bit")
    worst = 0.0
    for N, K, M in P1_BF16_SHAPES + tuple((n, k // 2, m) for n, k, m in EDGE_SHAPES):
        x, w = bf16_pair(N, K, M, gen)
        got = dense_mm.mm(x, w, torch.float32)
        torch.cuda.synchronize()
        gap = mm_bf16_gap(x, w, got)
        worst = max(worst, gap)
        log(f"[kernels] dense_mm bf16 -> f32 {(N, K, M)}: max |err| / (|x| @ |w|) {gap:.3g} "
            f"(tolerance {MM_BF16_TOL:g}) {'ok' if gap <= MM_BF16_TOL else 'FAIL'}")
        if not gap <= MM_BF16_TOL:
            raise AssertionError(f"dense_mm bf16 disagrees with its plain version at {(N, K, M)}")
    return {"s8_max_abs_err": 0, "bf16_rel_err": worst}


def ffn_inputs(N: int, H: int, M: int, gen: torch.Generator):
    """bf16 x, W at unit output scale and a bias of half that scale, so that
    both roundings before the gelu matter."""
    return (torch.randn(N, H, generator=gen, device="cuda").bfloat16(),
            (torch.randn(H, M, generator=gen, device="cuda") / H ** 0.5).bfloat16(),
            (0.5 * torch.randn(M, generator=gen, device="cuda")).bfloat16())


def ffn_gap(x, w, b, got: torch.Tensor, mode: str) -> tuple[float, float, float]:
    """(largest error in bf16 ulps of max(|x @ w|, |b|, |ref|), share of the
    outputs that differ, largest absolute error) against the plain version."""
    ref = ffn.dense_gelu_reference(x, w, b, mode).float()
    scale = torch.maximum(torch.matmul(x.float(), w.float()).abs(), b.float().abs()[None])
    _, e = torch.frexp(torch.maximum(scale, ref.abs()))
    err = (got.float() - ref).abs()
    return (float((err / torch.ldexp(torch.ones_like(ref), e - 8)).max()),
            float((err > 0).float().mean()), float(err.max()))


def check_ffn(gen: torch.Generator) -> float:
    """K6 against dense_gelu_reference, erf and tanh, at t30_150M's wi for
    K6_ROWS tokens, and erf at the main loop's edges; then the plain version
    with either epilogue rounding skipped must fail the share bound."""
    worst = 0.0
    cases = [(N, 640, 2560, mode) for N in K6_ROWS for mode in ("erf", "tanh")]
    cases += [(n, k // 2, m, "erf") for n, k, m in EDGE_SHAPES]
    for N, H, M, mode in cases:
        x, w, b = ffn_inputs(N, H, M, gen)
        got = ffn.dense_gelu(x, w, b, mode)
        torch.cuda.synchronize()
        ulps, share, err = ffn_gap(x, w, b, got, mode)
        ok = bool(torch.isfinite(got.float()).all()) and ulps <= FFN_ULPS \
            and share <= FFN_SHARE
        worst = max(worst, err)
        log(f"[kernels] ffn_gelu N={N} H={H} M={M} {mode}: max |err| {err:.6g} = "
            f"{ulps:g} bf16 ulps (tolerance {FFN_ULPS}), {share:.3g} of the outputs differ "
            f"(tolerance {FFN_SHARE:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ffn_gelu disagrees with its plain version at "
                                 f"{(N, H, M)} {mode}")
    x, w, b = ffn_inputs(10240, 640, 2560, gen)
    acc = torch.matmul(x.float(), w.float())
    for what, z in (("the rounding before the bias", (acc + b.float()).bfloat16()),
                    ("the rounding of the biased sum", acc.bfloat16().float() + b.float())):
        share = ffn_gap(x, w, b, ffn._gelu_f32(z.float(), "erf").bfloat16(), "erf")[1]
        log(f"[kernels] ffn_gelu check against a plain version that skips {what}: {share:.3g} "
            f"of the outputs differ ({share / FFN_SHARE:.4g} x the tolerance)")
        if share <= FFN_SHARE:
            raise AssertionError(f"the ffn_gelu check does not see a skipped rounding ({what})")
    return worst


def ffn_f32_inputs(N: int, H: int, M: int, seed: int):
    """f32 x, W at unit output scale and a bias of half that scale, from
    their own seed (the planted fault reads the same inputs)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(N, H, generator=gen, device="cuda"),
            torch.randn(H, M, generator=gen, device="cuda") / H ** 0.5,
            0.5 * torch.randn(M, generator=gen, device="cuda"))


def ffn_f32_cases() -> list[tuple[int, int, int, str]]:
    """K6-f32's (N, H, M, mode) cases: t30_150M's wi at K6_ROWS tokens, erf
    and tanh; the main loop's edges (bf16's H) and K6_F32_EDGES; each
    family's wi at K6_F32_FAMILY_ROWS tokens."""
    cases = [(N, 640, 2560, mode) for N in K6_ROWS for mode in ("erf", "tanh")]
    cases += [(n, k // 2, m, "erf") for n, k, m in EDGE_SHAPES]
    cases += [(n, h, m, "erf") for n, h, m in K6_F32_EDGES]
    cases += [(n, h, m, "erf") for h, m in FFN_WIDTHS for n in K6_F32_FAMILY_ROWS]
    return cases


def k6_f32_readings(cases: list) -> list[dict]:
    """K6-f32 (or whatever ops.ffn launches for f32) against
    dense_gelu_reference on each case's inputs: the largest error over its
    tolerance (ratio), and in rms(ref) units (rel_rms); ffn_gelu_f32 must
    launch once a case and ffn_gelu never."""
    rows = []
    for i, (N, H, M, mode) in enumerate(cases):
        x, w, b = ffn_f32_inputs(N, H, M, SEED + i)
        before = dict(ffn.launches)
        got = ffn.dense_gelu(x, w, b, mode)
        ref = ffn.dense_gelu_reference(x, w, b, mode)
        torch.cuda.synchronize()
        if ffn.launches != {**before, "ffn_gelu_f32": before["ffn_gelu_f32"] + 1}:
            raise AssertionError(f"ffn_gelu_f32 at {(N, H, M)}: launches {ffn.launches}, "
                                 f"before {before}")
        err = (got - ref).abs()
        rms = float(ref.square().mean().sqrt())
        finite = bool(torch.isfinite(got).all())
        rows.append({"case": (N, H, M, mode), "finite": finite,
                     "ratio": float((err / (F32_ATOL_RMS * rms + F32_RTOL * ref.abs())).max())
                     if finite else math.inf,
                     "rel_rms": float(err.max()) / rms, "max_abs_err": float(err.max())})
        del x, w, b, got, ref, err
    return rows


def check_ffn_f32(cases: list) -> float:
    """K6-f32 against dense_gelu_reference at every case of ffn_f32_cases:
    finite and within F32_ATOL_RMS * rms(ref) + F32_RTOL * |ref|. Returns
    the largest absolute error."""
    rows = k6_f32_readings(cases)
    for r in rows:
        log(f"[kernels] ffn_gelu_f32 (N, H, M, mode) = {r['case']}: max |err| "
            f"{r['max_abs_err']:.6g} = {r['rel_rms']:.3g} rms(ref) ({r['ratio']:.4g} x the "
            f"tolerance {F32_ATOL_RMS:g} rms(ref) + {F32_RTOL:g} |ref|) "
            f"{'ok' if r['finite'] and r['ratio'] <= 1 else 'FAIL'}")
        if not (r["finite"] and r["ratio"] <= 1):
            raise AssertionError(f"ffn_gelu_f32 disagrees with its plain version at {r['case']}")
    worst = max(rows, key=lambda r: r["rel_rms"])
    log(f"[kernels] ffn_gelu_f32: {len(rows)} cases, worst {worst['rel_rms']:.3g} rms(ref) at "
        f"{worst['case']} (limit {F32_ATOL_RMS:g} rms(ref))")
    return max(r["max_abs_err"] for r in rows)


FFN_F32_FAULTS = {"ffn_f32_k_tile": "K6-f32's k-loop drops its last k-tile",
                  "ffn_f32_tf32": "K6-f32 in plain TF32, one product a k-step"}


def check_ffn_f32_fault(libs: dict, cases: list) -> dict:
    """K6-f32's check against its planted faults (FFN_F32_FAULTS): each must
    fail every case."""
    out = {}
    for name, what in FFN_F32_FAULTS.items():
        with ffn_kernels(libs[name]):
            rows = k6_f32_readings(cases)
        passed = [r["case"] for r in rows if r["ratio"] <= 1]
        least = min(rows, key=lambda r: r["ratio"])
        log(f"[kernels] planted fault {name} ({what}): fails {len(rows) - len(passed)} of "
            f"{len(rows)} cases, at least {least['ratio']:.4g} x the tolerance "
            f"({least['case']}), worst {max(r['ratio'] for r in rows):.4g} x; cases it passes: "
            f"{passed or 'none'}")
        if passed:
            raise AssertionError(f"the ffn_gelu_f32 check does not see the planted fault {name}")
        out[name.replace("ffn_f32", "ffn_gelu_f32")] = {
            "cases": len(rows), "cases_failed": len(rows), "least_ratio": least["ratio"],
            "worst_ratio": max(r["ratio"] for r in rows)}
    return out


def build_faults(names=tuple(FAULTS)) -> dict:
    """The planted faults ``names`` of FAULTS, each kernel of one built from
    its own patched copy of csrc/ under _build/fault/<name>/: {name:
    {kernel: library path}}; a kernel that two faults patch alike is built
    once, for the first. All builds run at once."""
    jobs, libs, built = [], {}, {}
    for name in names:
        header, line, patched, kernels = FAULTS[name]
        shutil.rmtree(FAULT_DIR / name, ignore_errors=True)
        src = FAULT_DIR / name / "csrc"
        shutil.copytree(build.CSRC_DIR, src)
        text = (src / header).read_text()
        if text.count(line) != 1:
            raise AssertionError(f"the planted fault's line ({name}) is not in csrc/{header} once")
        (src / header).write_text(text.replace(line, patched))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(src)]
        for kernel in kernels:
            lib = built.setdefault((header, line, patched, kernel),
                                   FAULT_DIR / name / f"lib{kernel}_fault.so")
            libs.setdefault(name, {})[kernel] = lib
            if lib.parent.name == name:
                jobs.append((cmd, src / f"{kernel}.cu", lib))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: build.compile_library(*job), jobs))
    return libs


@contextlib.contextmanager
def ffn_kernels(libs: dict):
    """ops.ffn launches the planted-fault builds in ``libs`` ({kernel:
    library}) while the block runs, and its own builds of the others."""
    saved = ffn._launcher
    faulty = {name: ffn.bind(ctypes.CDLL(str(lib)), name) for name, lib in libs.items()}
    ffn._launcher = lambda name: faulty[name] if name in faulty else saved(name)
    try:
        yield
    finally:
        ffn._launcher = saved


def reordered_dense_gelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         mode: str) -> torch.Tensor:
    """dense_gelu's plain version in exact f32 summed in another order (the
    two halves of H through cuBLAS, TF32 off, then added): how far the f32
    steps move when only the wi product's f32 roundings change."""
    if x.dtype != torch.float32:
        raise TypeError(f"reordered_dense_gelu takes f32, got {x.dtype}")
    h = x.shape[1] // 2
    z = torch.matmul(x[:, :h], w[:h]) + torch.matmul(x[:, h:], w[h:]) + b
    return ffn._gelu_f32(z, mode)


@contextlib.contextmanager
def ffn_forward(fn):
    """ops.ffn's forward is ``fn`` while the block runs (under the gate)."""
    saved = ffn._forward
    ffn._forward = fn
    try:
        yield
    finally:
        ffn._forward = saved


@contextlib.contextmanager
def fault_kernels(libs: dict):
    """The wrappers launch the main-loop planted-fault builds of P1 and K6
    while the block runs."""
    saved = dense_mm._launchers
    faulty_mm = dense_mm.bind(ctypes.CDLL(str(libs["dense_mm"])))
    dense_mm._launchers = lambda: faulty_mm
    try:
        with ffn_kernels({"ffn_gelu": libs["ffn_gelu"]}):
            yield
    finally:
        dense_mm._launchers = saved


@contextlib.contextmanager
def attention_kernels(libs: dict, names=("attention_fwd", "attention_bwd", *F32_KERNELS)):
    """ops.attention launches the planted-fault builds of ``names`` while
    the block runs, and its own builds of the others."""
    saved = attention._launcher
    faulty = {name: attention.bind(ctypes.CDLL(str(libs[name])), name) for name in names}
    attention._launcher = lambda name: faulty[name] if name in faulty else saved(name)
    try:
        yield
    finally:
        attention._launcher = saved


ATTENTION_FAULTS = {"swept_tiles": "last tile of the swept loop dropped",
                    "skip": "skip predicate off by one at a segment boundary",
                    "attention_f32_tf32": "f32 kernels in plain TF32, one product a k-step"}


def check_attention_faults(libs: dict, k1_cases: list, k5_cases: list,
                           dtype: torch.dtype = torch.bfloat16) -> dict:
    """K1's and K5's checks (in ``dtype``: K1-f32's and K5-f32's in f32)
    against each attention fault (swept_tiles and skip; in f32 also
    attention_f32_tf32), on the same inputs, each kernel's fault alone (K5 is fed
    the sound K1's statistics): each must fail the check, the skip fault
    every packed case of it, and every fault every case on the packed
    unfrozen path and a case at each of FAULT_HEAD_DIMS. Returns the worst
    ratio to the tolerance per check, how many cases failed and the least
    ratio on the packed unfrozen path."""
    out = {}
    fwd, bwd = attention._kernel("attention_fwd", dtype), attention._kernel("attention_bwd", dtype)
    names = [*ATTENTION_FAULTS] if dtype == torch.float32 else ["swept_tiles", "skip"]
    for name in names:
        with attention_kernels(libs[name], (fwd,)):
            k1 = k1_readings(k1_cases)
        with attention_kernels(libs[name], (bwd,)):  # fed the sound K1's lse
            k5 = k5_readings(k5_cases)
        for kernel, rows, ratio in (
                (fwd, k1, lambda r: max(r["need"] / r["atol"], r["lse_err"] / LSE_ATOL)),
                (bwd, k5, lambda r: max(r["needs"].values()) / r["atol"])):
            ratios = [ratio(r) for r in rows]
            failed = [r["case"] for r, x in zip(rows, ratios) if x > 1]
            packed_missed = [r["case"] for r, x in zip(rows, ratios) if r["packed"] and x <= 1]
            path_missed = [r["case"] for r, x in zip(rows, ratios) if r["path"] and x <= 1]
            path = [x for r, x in zip(rows, ratios) if r["path"]]
            by_dh = {dh: sum(r["dh"] == dh and x > 1 for r, x in zip(rows, ratios))
                     for dh in FAULT_HEAD_DIMS}
            worst_dh = {dh: max(x for r, x in zip(rows, ratios) if r["dh"] == dh)
                        for dh in FAULT_HEAD_DIMS}
            out[f"{kernel}_{name}"] = {"worst_ratio": max(ratios), "cases_failed": len(failed),
                                       "cases": len(rows), "least_ratio_unfrozen_path": min(path),
                                       "cases_failed_by_head_dim": by_dh,
                                       "worst_ratio_by_head_dim": worst_dh}
            log(f"[kernels] planted fault {name} ({ATTENTION_FAULTS[name]}): "
                f"{kernel} fails {len(failed)} of {len(rows)} cases, worst at {max(ratios):.4g} x "
                f"its tolerance; on the packed unfrozen path's {len(path)} chunks at least "
                f"{min(path):.4g} x; packed cases it passes: {packed_missed or 'none'}; cases "
                f"failed at head dims {', '.join(f'{dh}: {n}' for dh, n in by_dh.items())} "
                f"(worst {', '.join(f'{dh}: {x:.4g} x' for dh, x in worst_dh.items())})")
            if (not failed or path_missed or (name == "skip" and packed_missed)
                    or not all(by_dh.values())):
                raise AssertionError(f"the {kernel} check does not see the planted fault {name}")
    return out


def check_faults(libs: dict, gen: torch.Generator) -> dict:
    """Each check above against the planted fault, in the large block and in
    the small one (128 tokens): it must fail every check, and by how much is
    returned (and goes to PERF.md)."""
    out = {}
    with fault_kernels(libs):
        for key, (N, K, M) in (("dense_mm_s8", (1000, 640, 2560)),
                               ("dense_mm_s8_small", (128, 2560, 640))):
            x, w = s8_pair(N, K, M, gen)
            got = dense_mm.mm(x, w, torch.int32)
            want = dense_mm.mm_reference(x, w, torch.int32)
            torch.cuda.synchronize()
            diff = (got.long() - want.long()).abs()
            out[key] = {"shape": [N, K, M], "share_differ": float((diff > 0).float().mean()),
                        "max_abs_diff": int(diff.max())}
        x, w = bf16_pair(8192, 2560, 2560, gen)
        out["dense_mm_bf16"] = {"shape": [8192, 2560, 2560],
                                "x_tolerance": mm_bf16_gap(x, w, dense_mm.mm(x, w, torch.float32))
                                / MM_BF16_TOL}
        for key, N in (("ffn_gelu", 3072), ("ffn_gelu_small", 128)):
            x, w, b = ffn_inputs(N, 640, 2560, gen)
            ulps, share, err = ffn_gap(x, w, b, ffn.dense_gelu(x, w, b, "erf"), "erf")
            out[key] = {"shape": [N, 640, 2560], "ulps_x_tolerance": ulps / FFN_ULPS,
                        "share_x_tolerance": share / FFN_SHARE, "max_abs_err": err}
    log(f"[kernels] planted fault (main loop drops its last k-tile): dense_mm s8 differs in "
        f"{out['dense_mm_s8']['share_differ']:.6g} of the outputs, by up to "
        f"{out['dense_mm_s8']['max_abs_diff']} (at 128 tokens in "
        f"{out['dense_mm_s8_small']['share_differ']:.6g}, by up to "
        f"{out['dense_mm_s8_small']['max_abs_diff']}); dense_mm bf16 at "
        f"{out['dense_mm_bf16']['x_tolerance']:.4g} x its tolerance; ffn_gelu at "
        f"{out['ffn_gelu']['ulps_x_tolerance']:.4g} x its ulp bound and "
        f"{out['ffn_gelu']['share_x_tolerance']:.4g} x its share bound (at 128 tokens "
        f"{out['ffn_gelu_small']['ulps_x_tolerance']:.4g} and "
        f"{out['ffn_gelu_small']['share_x_tolerance']:.4g})")
    if (min(out[k]["max_abs_diff"] for k in ("dense_mm_s8", "dense_mm_s8_small")) == 0
            or out["dense_mm_bf16"]["x_tolerance"] <= 1
            or min(out[k][b] for k in ("ffn_gelu", "ffn_gelu_small")
                   for b in ("ulps_x_tolerance", "share_x_tolerance")) <= 1):
        raise AssertionError("a check does not see the planted fault")
    return out


# ---------------------------------------------------------------------------
# Phase 3: the serving path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counted_forwards():
    """Record the shape of every backbone forward while the block runs."""
    forwards = []
    plain_forward = esm2.forward

    def counted_forward(params, ids, mask, c, **kw):
        forwards.append(tuple(ids.shape))
        return plain_forward(params, ids, mask, c, **kw)

    esm2.forward = counted_forward
    ACTIVE_FORWARDS.append(forwards)
    try:
        yield forwards
    finally:
        esm2.forward = plain_forward
        ACTIVE_FORWARDS[:] = [f for f in ACTIVE_FORWARDS if f is not forwards]


# The forward lists counted_forwards is filling; and the training runs'
# heatmaps (figures), whose backbone forwards and launches are kept apart
# from their run's (figure_counts)
ACTIVE_FORWARDS: list[list] = []
FIGURES = {"heatmaps": 0, "forwards": 0, "launches": {}, "apart": True}


def counts() -> dict:
    """Every kernel wrapper's launch count."""
    return {**{f"attention:{k}": v for k, v in attention.launches.items()},
            **{f"ffn:{k}": v for k, v in ffn.launches.items()},
            "filip_maxsim": maxsim.filip_similarity_fused.launches, "dense_mm": dense_mm.mm.launches,
            **{f"{name}:{part}": getattr(fn, part) for name, fn in (
                ("infonce", infonce.fused_infonce), ("infonce_tiled", infonce.fused_infonce_tiled))
               for part in ("launches", "bwd_launches")}}


def set_counts(values: dict) -> None:
    for key, v in values.items():
        name, _, part = key.partition(":")
        if name == "attention":
            attention.launches[part] = v
        elif name == "ffn":
            ffn.launches[part] = v
        elif name == "filip_maxsim":
            maxsim.filip_similarity_fused.launches = v
        elif name == "dense_mm":
            dense_mm.mm.launches = v
        else:
            setattr(infonce.fused_infonce if name == "infonce" else infonce.fused_infonce_tiled,
                    part, v)


def reset_counts() -> None:
    set_counts(dict.fromkeys(counts(), 0))


def kernel_counts(values: dict) -> dict:
    """counts()' forward launches by kernel name (the kernels line's)."""
    out = {}
    for key, v in values.items():
        name, _, part = key.partition(":")
        if part != "bwd_launches" and v:
            out[part if name in ("attention", "ffn") else name] = v
    return out


def count_figures(plain):
    """``plain`` (viz/plots.plot_embedding_cosine_similarities) counting each
    heatmap the CLIs compute (the training runs' raw and trained ones,
    cli.cosine_similarity's) in FIGURES, a path of its own: its backbone
    forwards are taken off the counted_forwards lists and its launches off
    the wrappers' counts, so each run's counts stay those of its steps and
    eval batches. A heatmap runs two backbone forwards (both sides of one
    batch), each launching the attention forward once a layer. With
    FIGURES["apart"] false the launches stay in the counts (the eval phase
    counts them)."""

    def counted(*args, **kwargs):
        before, lengths = counts(), [len(f) for f in ACTIVE_FORWARDS]
        with counted_forwards() as forwards:
            out = plain(*args, **kwargs)
        grew = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        k1 = sum(v for k, v in grew.items() if k.startswith("attention:attention_fwd"))
        if len(forwards) != 2 or k1 % 2 or k1 // 2 not in (30, 33):
            raise AssertionError(f"a heatmap ran {len(forwards)} backbone forwards, launches "
                                 f"{grew}")
        if FIGURES["apart"]:
            FIGURES["heatmaps"] += 1
            FIGURES["forwards"] += len(forwards)
            for k, v in grew.items():
                FIGURES["launches"][k] = FIGURES["launches"].get(k, 0) + v
            set_counts(before)
            for f, n in zip(ACTIVE_FORWARDS, lengths):
                del f[n:]
        return out

    return counted


def check_default_path(what: str) -> None:
    """The default bf16 paths launch neither P1, K6 (bf16 or f32) nor the
    f32 attention kernels."""
    off = {name: attention.launches[name] for name in F32_KERNELS}
    off.update(ffn.launches, dense_mm=dense_mm.mm.launches)
    if any(off.values()):
        raise AssertionError(f"{what}: launches {off} on the default path")


def infonce_counts() -> dict:
    return {name: (fn.launches, fn.bwd_launches) for name, fn in
            (("infonce", infonce.fused_infonce), ("infonce_tiled", infonce.fused_infonce_tiled))}


def synthetic_seqs(rng: np.random.Generator, lengths) -> list[str]:
    return ["".join(rng.choice(list(AAS), int(n))) for n in lengths]


def call(base: str, path: str, payload=None, headers=None):
    req = urllib.request.Request(
        base + path, data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.headers, r.read()


def post_json(base: str, path: str, payload) -> dict:
    return json.loads(call(base, path, payload)[1])


def embed_json(base: str, seqs: list[str], side: str) -> np.ndarray:
    emb = np.asarray(post_json(base, "/embed", {"sequences": seqs, "side": side})
                     ["embeddings"], np.float32)
    if emb.shape != (len(seqs), 128) or not np.isfinite(emb).all():
        raise AssertionError(f"/embed returned shape {emb.shape} or non-finite values")
    return emb


def concurrent_burst(base: str, n_clients: int = 16, n_reqs: int = 4) -> dict:
    """Closed-loop clients released together; returns the /metrics delta."""
    before = json.loads(call(base, "/metrics")[1])
    barrier = threading.Barrier(n_clients)
    errors: list[BaseException] = []

    def client(i: int):
        crng = np.random.default_rng(1000 + i)
        try:
            barrier.wait(timeout=120)
            for _ in range(n_reqs):
                embed_json(base, synthetic_seqs(crng, [crng.integers(8, 40)]), "pep")
        except BaseException as e:  # noqa: BLE001 — re-raised in the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent clients failed: {errors[:1]}")
    after = json.loads(call(base, "/metrics")[1])
    return {k: after[k] - before[k] for k in ("requests", "sequences", "device_batches")}


def run_serve_phase(rng: np.random.Generator) -> dict:
    """The main path, start to end; returns what phases 4 and 5 need."""
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir()
    cfg = common.esm_config("t30_150M", "bfloat16")
    assert cfg.attention_impl == "fused", cfg
    mcfg = clip.CLIPConfig(input_dim=cfg.hidden_size, esm=cfg)
    t0 = time.perf_counter()
    esm_params = esm2.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                                  dtype=torch.bfloat16, device="cuda")
    heads = clip.init_params(mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    export_npz(WORK / "esm_t30_150M.npz", esm_params)
    export_npz(WORK / "best_model.npz", heads)
    fasta = WORK / "corpus.fasta"
    corpus = synthetic_seqs(rng, rng.integers(30, 500, 256))
    fasta.write_text("".join(f">seq{i}\n{s}\n" for i, s in enumerate(corpus)))
    log(f"[serve] t30_150M bf16 random weights (seed {SEED}) and heads written in "
        f"{time.perf_counter() - t0:.1f} s")
    model_args = ["--checkpoint", str(WORK / "best_model.npz"),
                  "--esm-weights", str(WORK / "esm_t30_150M.npz"), "--batch-size", "32"]

    # Count backbone forwards beside the kernels' launches.
    with counted_forwards() as forwards:
        reset_counts()
        embed.main(model_args + ["--fasta", str(fasta), "--side", "rec",
                                 "--out", str(WORK / "index.npz")])
        args = serve.build_argparser().parse_args(
            model_args + ["--index", str(WORK / "index.npz"), "--port", "0"])
        server = serve.make_server(args)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        out: dict = {"base": base, "server": server, "thread": thread, "mcfg": mcfg,
                     "esm_params": esm_params, "heads": heads, "model_args": model_args}

        health = json.loads(call(base, "/healthz")[1])
        if not (health["status"] == "ok" and health["index_size"] == 256
                and health["filip"] is False):
            raise AssertionError(f"/healthz {health}")
        log(f"[serve] /healthz {health}")

        singles = {}  # (side, bucket) -> (seq, embedding)
        for bucket, n in ((64, 40), (128, 100), (512, 400), (2048, 1800)):
            seq = synthetic_seqs(rng, [n])[0]
            for side in ("pep", "rec"):
                singles[(side, bucket)] = (seq, embed_json(base, [seq], side)[0])
        log(f"[serve] single-sequence /embed at buckets 64/128/512/2048, both sides: ok")

        batch32 = synthetic_seqs(rng, rng.integers(50, 300, 32))
        emb32 = embed_json(base, batch32, "rec")
        headers, body = call(base, "/embed", {"sequences": batch32, "side": "rec"},
                             {"Accept": "application/octet-stream"})
        shape = tuple(int(d) for d in headers["X-Shape"].split(","))
        wire = np.frombuffer(body, "<f4").reshape(shape)
        if shape != emb32.shape or not np.array_equal(wire, emb32):
            raise AssertionError("binary /embed differs from the JSON path")
        log(f"[serve] 32-sequence /embed {emb32.shape}, binary wire bit-equal to JSON")

        queries = batch32[:4]
        hits = post_json(base, "/topk", {"queries": queries, "side": "pep", "k": 10})["hits"]
        qemb = embed_json(base, queries, "pep")
        with np.load(WORK / "index.npz") as index:
            ids, corpus = index["ids"], index["embeddings"]
        want = np.argsort(-(qemb @ corpus.T), axis=1)[:, :10]
        for q, row in enumerate(hits):
            got_ids = [h["id"] for h in row]
            if [h["rank"] for h in row] != list(range(1, 11)) or got_ids != [
                    str(ids[i]) for i in want[q]]:
                raise AssertionError(f"/topk order wrong for query {q}")
            if not all(np.isfinite(h["score"]) for h in row):
                raise AssertionError("/topk returned a non-finite score")
        log(f"[serve] /topk k=10 over the 256-sequence index: order ok")

        for attempt in range(3):
            delta = concurrent_burst(base)
            log(f"[serve] 16 concurrent clients x 4 requests: {delta}")
            if delta["requests"] != 64 or delta["sequences"] != 64:
                raise AssertionError(f"/metrics lost requests: {delta}")
            if delta["device_batches"] < delta["requests"]:
                break
        else:
            raise AssertionError("no coalescing in 3 bursts of 16 concurrent clients")
        metrics = json.loads(call(base, "/metrics")[1])
        log(f"[serve] /metrics {metrics}")

        launches = attention.launches["attention_fwd"]
        k4_launches = maxsim.filip_similarity_fused.launches
        check_default_path("serve")
    if not forwards or launches != cfg.num_layers * len(forwards):
        raise AssertionError(f"attention_fwd launched {launches} times for "
                             f"{len(forwards)} backbone forwards; want "
                             f"{cfg.num_layers} per forward")
    log(f"[serve] {len(forwards)} backbone forwards, attention_fwd launches {launches} "
        f"= {cfg.num_layers} per forward; filip_maxsim launches {k4_launches}")
    out.update(launches={"attention_fwd": launches, "filip_maxsim": k4_launches},
               singles=singles, batch32=batch32, emb32=emb32)
    return out


# ---------------------------------------------------------------------------
# Phase 4: end to end against the plain attention
# ---------------------------------------------------------------------------

def check_end_to_end(ctx: dict) -> float:
    mcfg = ctx["mcfg"]
    eager = dataclasses.replace(mcfg, esm=dataclasses.replace(mcfg.esm, attention_impl="eager"))
    tok = common.make_tokenizer()

    def plain(seqs, side):
        return embed.embed_sequences(ctx["heads"], ctx["esm_params"], seqs, side, eager,
                                     tok, torch.device("cuda"), batch_size=32,
                                     pad_batch=True)

    def cosines(a, b):
        return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))

    cos = list(cosines(ctx["emb32"], plain(ctx["batch32"], "rec")))
    for (side, _), (seq, emb) in ctx["singles"].items():
        cos += list(cosines(emb[None], plain([seq], side)))
    worst = float(min(cos))
    log(f"[e2e] served (kernel) vs eager attention, {len(cos)} rows: min cosine "
        f"{worst:.6f} (need >= {COSINE_MIN})")
    if not worst >= COSINE_MIN:
        raise AssertionError(f"kernel path drifts from the eager path: cosine {worst}")
    return worst


# ---------------------------------------------------------------------------
# Phase 5: the FILIP serving path
# ---------------------------------------------------------------------------

def scorer_blocks(n_queries: int, n_index: int) -> int:
    """Kernel launches of one ragged scorer call: one per (64-query,
    1024-candidate) block."""
    return math.ceil(n_queries / 64) * math.ceil(n_index / 1024)


def plain_filip_scores(q_tokens: np.ndarray, q_lengths, index_path: Path,
                       temperature) -> tuple[np.ndarray, np.ndarray]:
    """(Q, N) direction-averaged scores of the queries against the whole
    ragged index by the plain max-sim on the card, and the index ids."""
    with np.load(index_path) as index:
        ids, flat, lengths = index["ids"], index["tokens"], index["lengths"]
    tb = 64 * math.ceil(int(lengths.max()) / 64)
    hb = np.zeros((len(ids), tb, flat.shape[1]), np.float32)
    for r, (start, n) in enumerate(zip(np.cumsum(lengths) - lengths, lengths)):
        hb[r, :n] = flat[start:start + n]
    mb = (np.arange(tb)[None, :] < lengths[:, None]).astype(np.int32)
    qm = (np.arange(q_tokens.shape[1])[None, :] < np.asarray(q_lengths)[:, None]).astype(np.int32)
    sa, sb = maxsim.maxsim_reference(*(torch.from_numpy(a).cuda()
                                       for a in (q_tokens, hb, qm, mb)))
    t = maxsim.clamped_temperature(temperature)
    return ((sa + sb) / 2 / t).cpu().numpy(), ids


def check_hits(name: str, got_ids: list[str], got_scores, plain_row: np.ndarray,
               ids: np.ndarray) -> float:
    """Each hit's plain score equals its returned score and the plain top-k
    score at its rank, within K4_ATOL (near-ties may swap, nothing else);
    returns the largest score difference."""
    pos = {str(x): i for i, x in enumerate(ids)}
    top = np.sort(plain_row)[::-1]
    worst = 0.0
    if len(set(got_ids)) != len(got_ids):
        raise AssertionError(f"{name}: repeated ids {got_ids}")
    for r, (hid, score) in enumerate(zip(got_ids, got_scores)):
        plain = float(plain_row[pos[hid]])
        worst = max(worst, abs(score - plain), abs(plain - float(top[r])))
    if not worst <= K4_ATOL:
        raise AssertionError(f"{name}: hits disagree with the plain scores by {worst:g}")
    return worst


def read_tsv(path: Path, k: int) -> list[list[tuple[str, float]]]:
    lines = path.read_text().splitlines()
    if lines[0] != "query_id\trank\thit_id\tscore":
        raise AssertionError(f"{path.name}: header {lines[0]!r}")
    rows = [ln.split("\t") for ln in lines[1:]]
    return [[(h, float(sc)) for _, _, h, sc in rows[q * k:(q + 1) * k]]
            for q in range(len(rows) // k)]


def run_filip_phase(ctx: dict, rng: np.random.Generator) -> dict:
    """FILIP heads over the same backbone: embed --filip, serve --filip,
    retrieve (both modes)."""
    cfg = ctx["mcfg"].esm
    fcfg = filip.FILIPConfig(input_dim=cfg.hidden_size, embedding_dim=FILIP_D, esm=cfg)
    fheads = filip.init_params(fcfg, torch.Generator().manual_seed(SEED + 1), device="cuda")
    export_npz(WORK / "filip_heads.npz", fheads)
    corpus = synthetic_seqs(rng, rng.integers(30, 500, 256))
    (WORK / "filip_corpus.fasta").write_text(
        "".join(f">f{i}\n{s}\n" for i, s in enumerate(corpus)))
    queries = synthetic_seqs(rng, [24, 100, 300, 450])       # buckets 32 to 512
    (WORK / "queries.fasta").write_text("".join(f">q{i}\n{s}\n" for i, s in enumerate(queries)))
    model_args = ["--checkpoint", str(WORK / "filip_heads.npz"),
                  "--esm-weights", str(WORK / "esm_t30_150M.npz"), "--batch-size", "32"]
    index_path = WORK / "filip_index.npz"
    k, n_index = 10, len(corpus)
    blocks = scorer_blocks(len(queries), n_index)

    def k4_calls(what: str, before: int) -> None:
        got = maxsim.filip_similarity_fused.launches - before
        if got != blocks:
            raise AssertionError(f"{what}: filip_maxsim launched {got} times, want {blocks}")

    with counted_forwards() as forwards:
        reset_counts()
        embed.main(model_args + ["--filip", "--fasta", str(WORK / "filip_corpus.fasta"),
                                 "--side", "rec", "--out", str(index_path)])
        with np.load(index_path) as index:
            lengths = index["lengths"]
            if index["tokens"].shape != (int(lengths.sum()), FILIP_D) or len(lengths) != 256:
                raise AssertionError("embed --filip wrote a malformed index")
        log(f"[filip] embed --filip: ragged index of {len(lengths)} sequences, "
            f"{int(lengths.sum())} tokens, lengths {int(lengths.min())}-{int(lengths.max())}")
        args = serve.build_argparser().parse_args(
            model_args + ["--index", str(index_path), "--port", "0", "--filip"])
        server = serve.make_server(args)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        out: dict = {"base": base, "server": server, "thread": thread, "fcfg": fcfg,
                     "fheads": fheads, "queries": queries, "index_path": index_path,
                     "corpus": corpus}
        health = json.loads(call(base, "/healthz")[1])
        if not (health["filip"] is True and health["index_size"] == 256):
            raise AssertionError(f"/healthz {health}")
        log(f"[filip] /healthz {health}")

        js = post_json(base, "/embed", {"sequences": queries, "side": "pep"})
        q_tokens = np.asarray(js["tokens"], np.float32)
        headers, body = call(base, "/embed", {"sequences": queries, "side": "pep"},
                             {"Accept": "application/octet-stream"})
        n_pre = int(headers["X-Prefix-Len"])
        prefix = np.frombuffer(body[:4 * n_pre], "<i4").tolist()
        shape = tuple(int(d) for d in headers["X-Shape"].split(","))
        wire = np.frombuffer(body[4 * n_pre:], "<f4").reshape(shape)
        true_lengths = [len(q) + 2 for q in queries]
        if not (np.isfinite(q_tokens).all() and q_tokens.shape == (4, 512, FILIP_D)):
            raise AssertionError(f"/embed tokens {q_tokens.shape} or non-finite")
        if not (np.array_equal(wire, q_tokens) and prefix == js["lengths"] == true_lengths):
            raise AssertionError("binary /embed or its length prefix differs from JSON")
        log(f"[filip] /embed JSON {q_tokens.shape}; binary bit-equal, prefix {prefix} "
            f"= true lengths")

        before = maxsim.filip_similarity_fused.launches
        hits = post_json(base, "/topk", {"queries": queries, "side": "pep", "k": k})["hits"]
        k4_calls("/topk", before)
        plain, ids = plain_filip_scores(q_tokens, prefix, index_path, fheads["temperature"])
        worst = 0.0
        for q, row in enumerate(hits):
            if [h["rank"] for h in row] != list(range(1, k + 1)):
                raise AssertionError(f"/topk ranks {row}")
            worst = max(worst, check_hits(f"/topk query {q}", [h["id"] for h in row],
                                          [h["score"] for h in row], plain[q], ids))
        log(f"[filip] /topk k={k}, {len(queries)} queries over {n_index}: {blocks} "
            f"filip_maxsim launch(es); scores and order within {worst:.3g} of the plain "
            f"max-sim")

        before = maxsim.filip_similarity_fused.launches
        retrieve.main(model_args + ["--filip", "--index", str(index_path), "--queries",
                                    str(WORK / "queries.fasta"), "--side", "pep", "--k",
                                    str(k), "--out", str(WORK / "filip_hits.tsv")])
        k4_calls("retrieve --filip", before)
        tsv = read_tsv(WORK / "filip_hits.tsv", k)
        for q, row in enumerate(tsv):
            check_hits(f"retrieve --filip query {q}", [h for h, _ in row],
                       [sc for _, sc in row], plain[q], ids)
        same = sum([h for h, _ in row] == [x["id"] for x in hits_row]
                   for row, hits_row in zip(tsv, hits))
        log(f"[filip] retrieve --filip: {len(tsv)} queries, {same} with /topk's ids in "
            f"/topk's order, all within {K4_ATOL:g} of the plain scores at each rank")

        retrieve.main(ctx["model_args"] + ["--index", str(WORK / "index.npz"), "--queries",
                                           str(WORK / "queries.fasta"), "--side", "pep",
                                           "--k", str(k), "--out", str(WORK / "clip_hits.tsv")])
        qemb = embed.embed_sequences(ctx["heads"], ctx["esm_params"], queries, "pep",
                                     ctx["mcfg"], common.make_tokenizer(),
                                     torch.device("cuda"), batch_size=32)
        with np.load(WORK / "index.npz") as index:
            clip_ids, clip_emb = index["ids"], index["embeddings"]
        clip_scores = qemb @ clip_emb.T
        for q, row in enumerate(read_tsv(WORK / "clip_hits.tsv", k)):
            check_hits(f"retrieve (CLIP) query {q}", [h for h, _ in row],
                       [sc for _, sc in row], clip_scores[q], clip_ids)
        log(f"[filip] retrieve (CLIP mode) against the 256-sequence CLIP index: ok")

        k1 = attention.launches["attention_fwd"]
        k4 = maxsim.filip_similarity_fused.launches
    if not forwards or k1 != cfg.num_layers * len(forwards):
        raise AssertionError(f"attention_fwd launched {k1} times for {len(forwards)} "
                             f"backbone forwards; want {cfg.num_layers} per forward")
    if k4 != 2 * blocks:
        raise AssertionError(f"filip_maxsim launched {k4} times; want {2 * blocks}")
    log(f"[filip] {len(forwards)} backbone forwards, attention_fwd launches {k1} = "
        f"{cfg.num_layers} per forward; filip_maxsim launches {k4}")
    out.update(launches={"attention_fwd": k1, "filip_maxsim": k4}, q_tokens=q_tokens,
               q_lengths=prefix)
    return out


# ---------------------------------------------------------------------------
# Phase 6: FILIP tokens end to end against the plain attention
# ---------------------------------------------------------------------------

def check_filip_end_to_end(ctx: dict, fctx: dict) -> float:
    eager = dataclasses.replace(fctx["fcfg"], esm=dataclasses.replace(
        fctx["fcfg"].esm, attention_impl="eager"))
    toks, mask = embed.embed_sequences_tokens(fctx["fheads"], ctx["esm_params"],
                                              fctx["queries"], "pep", eager,
                                              common.make_tokenizer(), torch.device("cuda"),
                                              batch_size=32, pad_batch=True)
    served = fctx["q_tokens"]
    valid = mask.astype(bool)
    if toks.shape != served.shape or valid.sum(1).tolist() != fctx["q_lengths"]:
        raise AssertionError(f"eager tokens {toks.shape} vs served {served.shape}")
    a, b = served[valid], toks[valid]
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    log(f"[filip e2e] served (kernel) vs eager attention, {len(cos)} valid tokens: "
        f"min cosine {cos.min():.6f}, median {np.median(cos):.6f} "
        f"(need min >= {FILIP_COSINE_MIN})")
    if not cos.min() >= FILIP_COSINE_MIN:
        raise AssertionError(f"FILIP tokens drift from the eager path: cosine {cos.min()}")
    return float(cos.min())


# ---------------------------------------------------------------------------
# Phase 7: the training path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def timed_steps(engine=clip_engine):
    """Record a CUDA event on the current stream after every train step of
    ``engine`` while the block runs. Nothing syncs: the steps overlap the
    host and the card as train_gc runs them, and the events are read after
    the epoch."""
    ends: list[torch.cuda.Event] = []
    plain_make = engine.make_train_step

    def make(cfg, loss_fn=None):
        step = plain_make(cfg, loss_fn)

        def timed(*args):
            out = step(*args)
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
            return out
        return timed

    engine.make_train_step = make
    try:
        yield ends
    finally:
        engine.make_train_step = plain_make


RUN_ARTIFACTS = ["best_model.npz", "figures", "losses_per_epoch.txt", "metrics.jsonl", "state"]


def check_run_dir(runs: Path, keep_state: bool = False) -> Path:
    """A one-epoch run's directory: its artifacts, finite losses, one
    snapshot (state/epoch_1.pt) and the raw and the two trained heatmaps'
    matrices (figures/*.npy; no PNG without matplotlib). The snapshot
    (10.4 GB for t33_650M's finetune run) is removed after the check unless
    ``keep_state``."""
    (run,) = list(runs.iterdir())
    names = sorted(p.name for p in run.iterdir())
    if names != RUN_ARTIFACTS:
        raise AssertionError(f"{run}: artifacts {names}")
    rows = (run / "losses_per_epoch.txt").read_text().splitlines()
    if rows[0] != "Epoch,Train Loss,Validation Loss" or len(rows) != 2:
        raise AssertionError(f"losses_per_epoch.txt: {rows}")
    values = [float(v) for v in rows[1].split(",")[1:]]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"non-finite losses {rows[1]}")
    snaps = sorted(p.name for p in (run / "state").iterdir())
    matrices = [np.load(f) for f in sorted((run / "figures").glob("*.npy"))]
    if snaps != ["epoch_1.pt"] or len(matrices) != 3 or not all(
            m.ndim == 2 and m.shape[0] == m.shape[1] and np.isfinite(m).all() for m in matrices):
        raise AssertionError(f"{run}: snapshots {snaps}, heatmaps "
                             f"{[m.shape for m in matrices]}")
    if not keep_state:
        shutil.rmtree(run / "state")
    return run


def loss_kernel(pool: int) -> str:
    """The InfoNCE kernel the train and eval steps run on a pool."""
    return "infonce" if clip_engine.fused_infonce_fits(pool) else "infonce_tiled"


def run_train(name: str, data_dir: Path, batch_size: int,
              families: int = FIXTURE_FAMILIES) -> dict:
    """cli.main for one epoch at --batch-size batch_size x 16 on a fixture of
    ``families``; checks the artifacts and every kernel's launch count
    against the loaders."""
    runs = WORK / f"runs_{name}"
    t0 = time.perf_counter()
    with counted_forwards() as forwards, timed_steps() as ends:
        reset_counts()
        train_cli.main(["--synthetic-fixture", "--data-dir", str(data_dir), "--fixture-families",
                        str(families), "--epochs", "1", "--runs-dir", str(runs),
                        "--batch-size", str(batch_size), "--accumulated-batches", "16"])
        k1 = attention.launches["attention_fwd"]
        counts = infonce_counts()
        check_default_path(name)
    wall = time.perf_counter() - t0
    run = check_run_dir(runs)
    train_ds, val_ds, test_ds = dataset.generate_datasets(data_dir, seed=42)
    steps = len(train_ds) // batch_size // 16
    evals = len(val_ds) // batch_size + len(test_ds) // batch_size
    want_forwards = 32 * steps + 8 * evals     # 4 groups x 2 sides x (4 chunks | 1)
    want = {"infonce": [0, 0], "infonce_tiled": [0, 0]}
    want[loss_kernel(16 * batch_size)][0] += steps
    want[loss_kernel(16 * batch_size)][1] += steps
    want[loss_kernel(batch_size)][0] += evals
    want = {k: tuple(v) for k, v in want.items()}
    if len(ends) != steps or len(forwards) != want_forwards or k1 != 30 * want_forwards:
        raise AssertionError(f"{name}: {len(ends)} steps (want {steps}), {len(forwards)} "
                             f"forwards (want {want_forwards}), {k1} attention_fwd launches")
    if counts != want:
        raise AssertionError(f"{name}: InfoNCE (forward, backward) calls {counts}, want {want}")
    metrics = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    log(f"[train] {name}: global batch {16 * batch_size}, {steps} steps, {evals} eval batches "
        f"of {batch_size}; train loss {metrics['train_loss']:.6f}, val loss "
        f"{metrics['val_loss']:.6f}; {len(forwards)} backbone forwards, attention_fwd "
        f"{k1} = 30 per forward; InfoNCE (forward, backward) calls {counts}; epoch "
        f"{metrics['seconds']:.2f} s, cli.main {wall:.2f} s")
    return {"run": run, "steps": steps, "ends": ends, "launches": {
        "attention_fwd": k1, "filip_maxsim": maxsim.filip_similarity_fused.launches,
        **{k: v[0] for k, v in counts.items()}}, "bwd": {k: v[1] for k, v in counts.items()}}


def run_unfrozen(name: str, data_dir: Path, mode_args: list[str], engine,
                 families: int = FIXTURE_FAMILIES) -> dict:
    """cli.main --finetune or --lora-rank for one epoch at the defaults
    (global batch 256 in one pad bucket, 16 chunks, remat) on a fixture of
    ``families``; checks the artifacts and every kernel's launch count
    against the loaders."""
    runs = WORK / f"runs_{name}"
    t0 = time.perf_counter()
    with counted_forwards() as forwards, timed_steps(engine) as ends:
        reset_counts()
        train_cli.main(["--synthetic-fixture", "--data-dir", str(data_dir), "--fixture-families",
                        str(families), "--epochs", "1", "--runs-dir", str(runs)]
                       + mode_args)
        k1 = attention.launches["attention_fwd"]
        k5 = attention.launches["attention_bwd"]
        counts = infonce_counts()
    wall = time.perf_counter() - t0
    run = check_run_dir(runs)
    train_ds, val_ds, test_ds = dataset.generate_datasets(data_dir, seed=42)
    steps = len(train_ds) // 16 // 16
    evals = len(val_ds) // 16 + len(test_ds) // 16
    chunks = 2 * 16                          # per step: 16 chunks of 16 pairs per side
    want_forwards = 2 * chunks * steps + 2 * evals       # pass 1 and pass 2; 2 per eval
    want_k1 = (30 * chunks + 60 * chunks) * steps + 60 * evals
    want_k5 = 30 * chunks * steps
    want = {"infonce": (steps + evals, steps), "infonce_tiled": (0, 0)}
    if (len(ends), len(forwards), k1, k5) != (steps, want_forwards, want_k1, want_k5):
        raise AssertionError(f"{name}: {len(ends)} steps (want {steps}), {len(forwards)} "
                             f"forwards (want {want_forwards}), attention_fwd {k1} (want "
                             f"{want_k1}), attention_bwd {k5} (want {want_k5})")
    if counts != want:
        raise AssertionError(f"{name}: InfoNCE (forward, backward) calls {counts}, want {want}")
    metrics = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    log(f"[train] {name}: global batch 256 in one pad bucket, {steps} steps, {evals} eval "
        f"batches of 16; train loss {metrics['train_loss']:.6f}, val loss "
        f"{metrics['val_loss']:.6f}; {len(forwards)} backbone forwards; attention_fwd {k1} "
        f"(30 per pass-1 forward, 60 per pass-2 chunk, 60 per eval batch), attention_bwd "
        f"{k5} (30 per pass-2 chunk); InfoNCE (forward, backward) calls {counts}; epoch "
        f"{metrics['seconds']:.2f} s, cli.main {wall:.2f} s")
    return {"run": run, "steps": steps, "ends": ends, "launches": {
        "attention_fwd": k1, "attention_bwd": k5,
        "filip_maxsim": maxsim.filip_similarity_fused.launches,
        **{k: v[0] for k, v in counts.items()}}}


def embed_check(path: Path, recs: list[str], what: str, family: str = "t30_150M") -> None:
    fasta = WORK / "train_embed.fasta"
    fasta.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(recs[:8])))
    embed.main(["--esm-config", family, "--checkpoint", str(path), "--fasta", str(fasta),
                "--side", "rec", "--out", str(WORK / "train_embed.npz")])
    with np.load(WORK / "train_embed.npz") as index:
        emb = index["embeddings"]
    if emb.shape != (8, 128) or not np.isfinite(emb).all():
        raise AssertionError(f"cli.embed with {what} gave {emb.shape}")
    log(f"[train] cli.embed with {what}: {emb.shape}, finite")


def run_train_phase() -> dict:
    """cli.main at global batch 256 (K2) on the 1100-family fixture (three
    steps, 20 eval batches) and at 1024 (K3) on the 3000-family one (two
    steps); then the one-bucket finetune and LoRA runs."""
    data_dir = WORK / "train_data"
    out = {"k2": run_train("train_256", WORK / SMALL_DATA, 16, SMALL_FIXTURE_FAMILIES),
           "k3": run_train("train_1024", data_dir, 64)}
    peps = sequences_only(WORK / SMALL_DATA / "peptide.fasta")
    recs = sequences_only(WORK / SMALL_DATA / "receptor.fasta")
    out["profile"] = (f"{SMALL_FIXTURE_FAMILIES} families, {len(recs)} pairs, receptors "
                      f"{min(map(len, recs))}-{max(map(len, recs))} aa, peptides "
                      f"{min(map(len, peps))}-{max(map(len, peps))} aa")
    log(f"[train] fixture of the run at 256: {out['profile']}; the run at 1024 trains on "
        f"{FIXTURE_FAMILIES} families")
    embed_check(out["k2"]["run"] / "best_model.npz", recs, "run 1's best_model.npz")
    # the one-bucket unfrozen runs on a fixture of their own: 2 steps of 8 s
    small = WORK / ONE_BUCKET_DATA
    out["finetune"] = run_unfrozen("train_finetune", small, ["--finetune"], finetune,
                                   ONE_BUCKET_FIXTURE_FAMILIES)
    embed_check(out["finetune"]["run"] / "best_model.npz", recs,
                "the finetune run's best_model.npz (its own backbone)")
    out["lora"] = run_unfrozen("train_lora", small, ["--lora-rank", str(LORA_RANK)], lora,
                               ONE_BUCKET_FIXTURE_FAMILIES)
    embed_check(out["lora"]["run"] / "best_model.npz", recs,
                "the LoRA run's best_model.npz (adapters merged into the base)")
    for run in ("finetune", "lora"):
        out[run]["profile"] = f"{ONE_BUCKET_FIXTURE_FAMILIES} families"
    return out


def chunk_rows(R: int, rows_per_chunk: int = 16) -> int:
    """The rows of each backbone chunk of a pack of R rows: the most equal
    chunks, at most R // rows_per_chunk of them, that divide R."""
    return R // max([d for d in range(1, R // rows_per_chunk + 1) if R % d == 0], default=1)


def wire_packs(batch: dict, side: str) -> list[dict]:
    """A packed wire's packs of one side: its width tiers, or the flat rows."""
    return list(batch.get(f"{side}_packs") or ({"ids": batch[f"{side}_ids"]},))


def packed_chunks(batch: dict) -> list[tuple[int, int]]:
    """The (rows, L) of each backbone chunk a packed batch takes: 16 rows a
    chunk of a side's widest rows, and more of its narrower width tiers
    (the same tokens a chunk), by chunk_rows' rule."""
    out = []
    for side in ("pep", "rec"):
        packs = wire_packs(batch, side)
        l_max = max(pk["ids"].shape[1] for pk in packs)
        for pk in packs:
            R, L = pk["ids"].shape
            rows = chunk_rows(R, 16 * (l_max // L))
            out += [(rows, L)] * (R // rows)
    return out


def unfrozen_chunk_shapes(batch: dict) -> list[tuple[int, int]]:
    """(rows, L) of the pep and the rec chunks the packed unfrozen step
    takes: a side of width L runs 16 x (the widest side's width / L) rows a
    chunk (the same tokens a chunk on both sides), by chunk_rows' rule."""
    widths = [batch[f"{side}_ids"].shape[1] for side in ("pep", "rec")]
    return [(chunk_rows(batch[f"{side}_ids"].shape[0], 16 * (max(widths) // L)), L)
            for side, L in zip(("pep", "rec"), widths)]


def unfrozen_chunks(batch: dict) -> list[tuple[int, int]]:
    """The (rows, L) of each backbone chunk of one pass of the packed
    unfrozen step."""
    out = []
    for side, (rows, L) in zip(("pep", "rec"), unfrozen_chunk_shapes(batch)):
        out += [(rows, L)] * (batch[f"{side}_ids"].shape[0] // rows)
    return out


def epoch_loaders(data_dir: Path) -> tuple:
    """The train, val and test loaders of ``cli.main``'s first epoch at the
    defaults, as the run builds and reseeds them (the test loader keeps its
    first draws)."""
    train_ds, val_ds, test_ds = dataset.generate_datasets(data_dir, seed=42)
    train, val, test = (dataset.PairLoader(ds, 16, shuffle=ds is train_ds, seed=42)
                        for ds in (train_ds, val_ds, test_ds))
    train.reseed_epoch(0)
    val.reseed_epoch(0)
    return train, val, test


def packed_epoch_batches(data_dir: Path, tiers: int = 1) -> tuple[list, list]:
    """The host batches of each step and of each eval batch of ``cli.main
    --packed [--pack-tiers tiers]``'s first epoch at the defaults, packed
    again here in the run's order from cleared tier caches (so the sticky
    widths, rows and spills are the run's)."""
    train, val, test = epoch_loaders(data_dir)
    tok = common.make_tokenizer()
    packed_engine.clear_tier_width_cache()
    steps = [packed_engine.tokenize_packed(tok, p, r, tiers=tiers)
             for p, r in clip_engine._accumulate(train, 16)]
    evals = [packed_engine.tokenize_packed(tok, p, r, tiers=tiers)
             for loader in (val, test) for p, r in loader]
    return steps, evals


def packed_epoch_chunks(data_dir: Path, step_chunks=packed_chunks,
                        tiers: int = 1) -> tuple[list, list]:
    """The backbone chunks of each step (by ``step_chunks``: the frozen
    step's, or one pass of the unfrozen step's with unfrozen_chunks) and of
    each eval batch of ``cli.main --packed``'s first epoch at the
    defaults (``packed_epoch_batches``)."""
    steps, evals = packed_epoch_batches(data_dir, tiers)
    return [step_chunks(b) for b in steps], [packed_chunks(b) for b in evals]


def run_packed_train(data_dir: Path, family: str = "t30_150M",
                     families: int = FIXTURE_FAMILIES, name: str = "train_packed",
                     tiers: int = 1) -> dict:
    """cli.main --packed (--esm-config family) for one epoch at the defaults
    (global batch 256, flat packing or ``--pack-tiers tiers``, 16 rows a
    chunk of a side's widest rows) on a fixture of ``families``; checks the
    artifacts and every kernel's launch count (K1 once a layer per chunk
    forward) against the chunks the loaders' batches take."""
    runs = WORK / f"runs_{name}"
    layers = common.esm_config(family, "bfloat16").num_layers
    t0 = time.perf_counter()
    with counted_forwards() as forwards, timed_steps() as ends:
        reset_counts()
        train_cli.main(["--synthetic-fixture", "--data-dir", str(data_dir), "--fixture-families",
                        str(families), "--epochs", "1", "--runs-dir", str(runs),
                        "--esm-config", family, "--packed", "--pack-tiers", str(tiers)])
        k1 = attention.launches["attention_fwd"]
        counts = infonce_counts()
        check_default_path(name)
    wall = time.perf_counter() - t0
    run = check_run_dir(runs)
    steps, evals = packed_epoch_chunks(data_dir, tiers=tiers)
    want_forwards = [c for chunks in steps + evals for c in chunks]
    want = {"infonce": (len(steps) + len(evals), len(steps)), "infonce_tiled": (0, 0)}
    if (len(ends), sorted(forwards), k1) != (len(steps), sorted(want_forwards),
                                             layers * len(want_forwards)):
        raise AssertionError(f"{name}: {len(ends)} steps (want {len(steps)}), "
                             f"{len(forwards)} chunk forwards (want {len(want_forwards)}), "
                             f"attention_fwd {k1} (want {layers * len(want_forwards)})")
    if counts != want:
        raise AssertionError(f"{name}: InfoNCE (forward, backward) calls {counts}, "
                             f"want {want}")
    metrics = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    per_step = sum(map(len, steps)) / len(steps)
    log(f"[train] {name} ({family}): global batch 256 packed"
        f"{f' in {tiers} width tiers' if tiers > 1 else ''}, {len(steps)} steps, "
        f"{len(evals)} eval batches of 16; train loss {metrics['train_loss']:.6f}, val loss "
        f"{metrics['val_loss']:.6f}; chunk forwards (rows, L) of the first step {steps[0]}, "
        f"{per_step:.2f} a step (the grouped step: 32); attention_fwd {k1} = {layers} per chunk "
        f"forward; InfoNCE (forward, backward) calls {counts}; epoch {metrics['seconds']:.2f} s, "
        f"cli.main {wall:.2f} s")
    return {"run": run, "steps": len(steps), "ends": ends, "chunks_per_step": per_step,
            "launches": {"attention_fwd": k1,
                         "filip_maxsim": maxsim.filip_similarity_fused.launches,
                         **{k: v[0] for k, v in counts.items()}},
            "bwd": {k: v[1] for k, v in counts.items()}}


def packed_setup(n: int = 256, family: str = "t30_150M"):
    """The family (t30_150M) in bf16 with the seeded weights of the train
    runs, CLIP heads (seed SEED, dropout 0.1), and the first n training pairs
    of the fixture."""
    cfg_esm = common.esm_config(family, "bfloat16")
    mcfg = clip.CLIPConfig(input_dim=cfg_esm.hidden_size, esm=cfg_esm)
    esm_params = esm2.init_params(cfg_esm, torch.Generator(device="cuda").manual_seed(0),
                                  dtype=torch.bfloat16, device="cuda")
    heads0 = clip.init_params(mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    return mcfg, esm_params, heads0, *fixture_pairs(n)


def fixture_pairs(n: int) -> tuple[list[str], list[str]]:
    """The first n training pairs of the 3000-family fixture (n a multiple
    of 16), as a global batch of 16 loader batches."""
    if not (WORK / "train_data" / "receptor.fasta").exists():
        write_fixture(WORK / "train_data", n_families=FIXTURE_FAMILIES, seed=42)
    train_ds, _, _ = dataset.generate_datasets(WORK / "train_data", seed=42)
    return next(clip_engine._accumulate(dataset.PairLoader(train_ds, n // 16, seed=SEED), 16))


def check_packed_paths() -> dict:
    """The 256 pairs' pooled embeddings in eval mode through the packed path
    (K1 on packed segments) against the grouped path (4 length groups, K1
    on padded rows): cosine >= COSINE_MIN per row on both sides. Then one
    packed train step (dropout 0.1) run twice from the same heads, Adam
    state and generator seed: the same loss and the same updated heads, to
    the bit."""
    mcfg, esm_params, heads0, peps, recs = packed_setup()
    tok = common.make_tokenizer()
    before = attention.launches["attention_fwd"]
    packed = to_device(packed_engine.tokenize_packed(tok, peps, recs), "cuda")
    got = packed_engine.embed_packed(heads0, esm_params, packed, mcfg)
    k1_packed = attention.launches["attention_fwd"] - before
    order = sorted(range(len(recs)), key=lambda i: len(recs[i]))   # tokenize_grouped's order
    with torch.inference_mode():
        pairs = [clip.forward(heads0, esm_params, clip_engine.expand_batch(to_device(b, "cuda")),
                              mcfg)
                 for b in clip_engine.tokenize_grouped(tok, peps, recs, 4)]
    inv = torch.argsort(torch.tensor(order, device="cuda"))
    cos = {side: row_cosines(g.cpu().numpy(),
                             torch.cat([p[j] for p in pairs])[inv].cpu().numpy())
           for j, (side, g) in enumerate(zip(("pep", "rec"), got))}
    cos_min = min(float(c.min()) for c in cos.values())
    log(f"[packed] embed_packed ({len(packed_chunks(packed))} chunk forwards, attention_fwd "
        f"{k1_packed}) against the grouped path on the same {len(recs)} pairs: cosine min pep "
        f"{float(cos['pep'].min()):.6f}, rec {float(cos['rec'].min()):.6f} (>= {COSINE_MIN})")
    if cos_min < COSINE_MIN or k1_packed != 30 * len(packed_chunks(packed)):
        raise AssertionError(f"packed embeddings: cosine {cos_min}, attention_fwd {k1_packed}")

    cfg = clip_engine.EngineConfig(model=mcfg, packed=True)
    runs = []
    for _ in range(2):
        params = clone_tree(heads0)
        state = optimizer.adam(TRAIN_LR).init(params)
        _, _, loss = clip_engine.make_train_step(cfg)(
            params, state, esm_params, packed, torch.Generator(device="cuda").manual_seed(1))
        runs.append((loss.cpu(), checkpoint._flatten(params)))
    (la, pa), (lb, pb) = runs
    same = bool(torch.equal(la, lb)) and all(torch.equal(pa[k], pb[k]) for k in pa)
    log(f"[packed] one packed train step twice from the same state (dropout 0.1, same "
        f"generator seed): losses {float(la):.9f}, {float(lb):.9f}; heads after the step "
        f"{'equal' if same else 'DIFFER'} to the bit")
    if not same:
        raise AssertionError("the packed train step is not deterministic")
    return {"cos_min": cos_min, "k1_embed": k1_packed, "deterministic": same}


def launches_per_step(packed: bool, engine=None, family: str = "t30_150M") -> dict:
    """Kernel launches, device busy time and peak memory of one train step
    of the family (t30_150M) at global batch 256 under torch.profiler:
    frozen (packed, or 4 length groups), or with ``engine`` (finetune) the
    packed unfrozen step. The peak is the step's own: what the process
    held before its weights were made is taken off."""
    gc.collect()
    base = torch.cuda.memory_allocated()
    mcfg, esm_params, heads0, peps, recs = packed_setup(family=family)
    cfg = clip_engine.EngineConfig(model=mcfg, packed=packed, length_groups=4)
    batch = to_device(clip_engine._prepare(common.make_tokenizer(), cfg)(peps, recs), "cuda")
    if engine is finetune:
        params, esm_params = finetune.init_params(esm_params, clone_tree(heads0)), {}
        state = finetune.make_optimizer(cfg).init(params)
    else:
        params = clone_tree(heads0)
        state = optimizer.adam(TRAIN_LR).init(params)
    step = (engine or clip_engine).make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    step(params, state, esm_params, batch, gen)                 # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels, wall = profiled_step(lambda: step(params, state, esm_params, batch, gen))
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    out = {"launches": sum(e.count for e in kernels), "busy_ms": busy_ms,
           "busy_share": busy_ms / (1e3 * wall),
           "peak_memory_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
    what = ("packed finetune" if engine is finetune else "packed" if packed else "grouped")
    log(f"[packed] one {family} {what} step under torch.profiler: {out['launches']} kernel launches, "
        f"device busy {busy_ms:.4f} ms of {1e3 * wall:.4f} ms "
        f"({100 * out['busy_share']:.2f}%); peak memory {out['peak_memory_gb']:.4f} GB")
    return out


def run_packed_phase() -> dict:
    data_dir = WORK / SMALL_DATA
    out = run_packed_train(data_dir, families=SMALL_FIXTURE_FAMILIES)
    embed_check(out["run"] / "best_model.npz", sequences_only(data_dir / "receptor.fasta"),
                "the packed run's best_model.npz")
    out["paths"] = timed("check_packed_paths", check_packed_paths)
    out["per_step"] = {"packed": timed("launches_per_step packed", launches_per_step, True),
                       "grouped": timed("launches_per_step grouped", launches_per_step, False)}
    return out


def run_packed_unfrozen(name: str, data_dir: Path, mode_args: list[str], engine,
                        family: str = "t30_150M", families: int = FIXTURE_FAMILIES,
                        dtype: torch.dtype = torch.bfloat16, gated: bool = False) -> dict:
    """cli.main --packed --finetune or --lora-rank (--esm-config family) for
    one epoch at the defaults (global batch 256, flat packing, remat) on a
    fixture of ``families``; checks the artifacts, the chunk forwards of
    each pass against those the loaders' batches take when packed again
    here by the unfrozen rule (unfrozen_chunks), and every kernel's launch
    count: per step K1 once a layer per pass-1 chunk and twice per pass-2
    chunk (forward and remat recompute), K5 once a layer per pass-2 chunk,
    K2 once forward and once backward; per eval batch K1 once a layer per
    chunk forward (the frozen rule) and K2 once. With ``dtype`` float32
    (``--esm-dtype float32``) K1-f32 and K5-f32 in their place, and no bf16
    attention launch; with ``gated`` (f32 under PCT_FFN_PALLAS=1, set by
    the caller) K6-f32 as often as K1-f32, once a layer per chunk forward
    and remat recompute, and no bf16 K6; else no K6 at all. The peak device
    memory is the run's own: the process's peak over the run less what it
    held before."""
    runs = WORK / f"runs_{name}"
    f32 = dtype == torch.float32
    L = common.esm_config(family, "bfloat16").num_layers
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with counted_forwards() as forwards, timed_steps(engine) as ends:
        reset_counts()
        train_cli.main(["--synthetic-fixture", "--data-dir", str(data_dir), "--fixture-families",
                        str(families), "--epochs", "1", "--runs-dir", str(runs),
                        "--esm-config", family, "--packed"] + mode_args
                       + (["--esm-dtype", "float32"] if f32 else []))
        k1 = attention.launches["attention_fwd"]
        k5 = attention.launches["attention_bwd"]
        k6 = ffn.launches["ffn_gelu_f32"]
        if f32:
            if k1 or k5 or dense_mm.mm.launches or ffn.launches["ffn_gelu"] or (k6 and not gated):
                raise AssertionError(f"{name}: bf16 attention_fwd {k1}, attention_bwd {k5}, "
                                     f"dense_mm {dense_mm.mm.launches}, ffn {ffn.launches} "
                                     f"launches on the f32 path (gated: {gated})")
            k1 = attention.launches["attention_fwd_f32"]
            k5 = attention.launches["attention_bwd_f32"]
        counts = infonce_counts()
        if not f32:
            check_default_path(name)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    run = check_run_dir(runs)
    steps, evals = packed_epoch_chunks(data_dir, unfrozen_chunks)
    step_chunks = [c for chunks in steps for c in chunks]
    eval_chunks = [c for chunks in evals for c in chunks]
    want_forwards = 2 * step_chunks + eval_chunks             # pass 1, pass 2, eval
    want_k1 = 3 * L * len(step_chunks) + L * len(eval_chunks)
    want_k5 = L * len(step_chunks)
    want = {"infonce": (len(steps) + len(evals), len(steps)), "infonce_tiled": (0, 0)}
    want_k6 = want_k1 if gated else 0
    if (len(ends), sorted(forwards), k1, k5, k6) != (len(steps), sorted(want_forwards), want_k1,
                                                     want_k5, want_k6):
        raise AssertionError(f"{name}: {len(ends)} steps (want {len(steps)}), {len(forwards)} "
                             f"chunk forwards (want {len(want_forwards)}), attention_fwd {k1} "
                             f"(want {want_k1}), attention_bwd {k5} (want {want_k5}), "
                             f"ffn_gelu_f32 {k6} (want {want_k6})")
    if counts != want:
        raise AssertionError(f"{name}: InfoNCE (forward, backward) calls {counts}, want {want}")
    metrics = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    per_pass = len(step_chunks) / len(steps)
    log(f"[train] {name} ({family}): global batch 256 packed, {len(steps)} steps, "
        f"{len(evals)} eval batches of 16; train loss {metrics['train_loss']:.6f}, val loss "
        f"{metrics['val_loss']:.6f}; chunk forwards (rows, L) of the first step's pass "
        f"{steps[0]}, {per_pass:.2f} a pass (the one-bucket step: 32); {len(forwards)} backbone "
        f"forwards; {attention._kernel('attention_fwd', dtype)} {k1} ({L} per pass-1 chunk, {2 * L} "
        f"per pass-2 chunk, {L} per eval chunk), {attention._kernel('attention_bwd', dtype)} {k5} ({L} "
        f"per pass-2 chunk); ffn_gelu_f32 {k6}{' (as attention_fwd_f32)' if gated else ''}; "
        f"InfoNCE (forward, backward) calls {counts}; epoch "
        f"{metrics['seconds']:.2f} s, cli.main {wall:.2f} s; peak device memory {peak:.4f} GB")
    return {"run": run, "steps": len(steps), "ends": ends, "chunks_per_pass": per_pass,
            "peak_memory_gb": peak, "seconds": wall,
            "launches": {attention._kernel("attention_fwd", dtype): k1,
                         attention._kernel("attention_bwd", dtype): k5,
                         "filip_maxsim": maxsim.filip_similarity_fused.launches,
                         "ffn_gelu_f32": k6, **{k: v[0] for k, v in counts.items()}}}


def run_packed_unfrozen_phase() -> dict:
    """cli.main --packed --finetune and --packed --lora-rank 8, each then
    embedding with its best_model.npz; one packed finetune step's launches,
    busy share and peak memory. The runs train on the 1100-family fixture
    (3 steps each)."""
    data_dir = WORK / SMALL_DATA
    if not (data_dir / "receptor.fasta").exists():   # as cli.main --synthetic-fixture writes it
        write_fixture(data_dir, n_families=SMALL_FIXTURE_FAMILIES, seed=42)
    recs = sequences_only(data_dir / "receptor.fasta")
    out = {"finetune": run_packed_unfrozen("train_finetune_packed", data_dir, ["--finetune"],
                                           finetune, families=SMALL_FIXTURE_FAMILIES)}
    embed_check(out["finetune"]["run"] / "best_model.npz", recs,
                "the packed finetune run's best_model.npz")
    out["lora"] = run_packed_unfrozen("train_lora_packed", data_dir,
                                      ["--lora-rank", str(LORA_RANK)], lora,
                                      families=SMALL_FIXTURE_FAMILIES)
    for run in ("finetune", "lora"):
        out[run]["profile"] = f"{SMALL_FIXTURE_FAMILIES} families"
    embed_check(out["lora"]["run"] / "best_model.npz", recs,
                "the packed LoRA run's best_model.npz")
    out["per_step"] = timed("launches_per_step packed finetune", launches_per_step, True,
                            finetune)
    return out


# ---------------------------------------------------------------------------
# Phase 7, FILIP training: cli.main_2protein_filip, K4 on its blocks, its
# backward against float64 autograd, its step against the plain max-sim
# ---------------------------------------------------------------------------

def filip_data(data_dir: Path) -> tuple:
    return dataset.generate_datasets(data_dir, "protein1", "protein2", seed=42,
                                     max_sequence_length=2000)


def filip_forwards_per_batch(batch_size: int, groups: int, chunks: int) -> int:
    """Backbone forwards of one FILIP train or eval batch, both sides: one
    bucket in _snap_chunks(batch, chunks) microbatches, or each of the
    length groups (tokenize_grouped: the last takes the remainder) in
    _snap_chunks(rows, chunks // groups)."""
    if groups == 1:
        return 2 * filip_engine._snap_chunks(batch_size, chunks)
    g = batch_size // groups
    rows = [g] * (groups - 1) + [batch_size - g * (groups - 1)]
    return 2 * sum(filip_engine._snap_chunks(r, max(1, chunks // groups)) for r in rows)


def run_filip_train(name: str, data_dir: Path, extra: list[str]) -> dict:
    """cli.main_2protein_filip for one epoch: the artifacts, and every
    kernel's launch count against the loaders: K1 30 per backbone forward,
    K4 groups^2 per train step and per eval batch, no other kernel."""
    runs = WORK / f"runs_{name}"
    argv = ["--synthetic-fixture", "--data-dir", str(data_dir), "--fixture-families",
            str(FILIP_FIXTURE_FAMILIES), "--epochs", "1", "--runs-dir", str(runs)] + extra
    args = filip_cli.build_argparser().parse_args(argv)
    bs, groups = args.batch_size, args.length_groups
    t0 = time.perf_counter()
    with counted_forwards() as forwards, timed_steps(filip_engine) as ends:
        reset_counts()
        filip_cli.main(argv)
        k1 = attention.launches["attention_fwd"]
        k4 = maxsim.filip_similarity_fused.launches
        k5 = attention.launches["attention_bwd"]
        counts = infonce_counts()
        check_default_path(name)
    wall = time.perf_counter() - t0
    run = check_run_dir(runs)
    train_ds, val_ds, test_ds = filip_data(data_dir)
    steps = len(train_ds) // bs
    evals = len(val_ds) // bs + len(test_ds) // bs
    want_forwards = filip_forwards_per_batch(bs, groups, args.num_chunks) * (steps + evals)
    want_k4 = groups ** 2 * (steps + evals)
    got = (len(ends), len(forwards), k1, k4, k5)
    want = (steps, want_forwards, 30 * want_forwards, want_k4, 0)
    if got != want or any(v != (0, 0) for v in counts.values()):
        raise AssertionError(f"{name}: (steps, backbone forwards, attention_fwd, filip_maxsim, "
                             f"attention_bwd) {got}, want {want}; InfoNCE calls {counts} "
                             f"(FILIP's loss is plain PyTorch)")
    metrics = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    log(f"[filip train] {name}: batch {bs} in {groups} length group(s), "
        f"{args.num_chunks} chunk(s){', DCL' if args.use_dcl else ''}; {steps} steps, {evals} "
        f"eval batches; train loss {metrics['train_loss']:.6f}, val loss "
        f"{metrics['val_loss']:.6f}; {len(forwards)} backbone forwards, attention_fwd {k1} = "
        f"30 per forward; filip_maxsim {k4} = {groups ** 2} per step and per eval batch; "
        f"epoch {metrics['seconds']:.2f} s, cli.main_2protein_filip {wall:.2f} s")
    return {"run": run, "args": args, "steps": steps, "evals": evals, "ends": ends,
            "launches": {"attention_fwd": k1, "filip_maxsim": k4}}


@functools.cache
def filip_setup() -> tuple:
    """(FILIP config, backbone) of the FILIP runs: t30_150M in bf16 with the
    CLIs' random init (seed 0), heads of dim FILIP_D."""
    cfg_esm = common.esm_config("t30_150M", "bfloat16")
    mcfg = filip.FILIPConfig(input_dim=cfg_esm.hidden_size, embedding_dim=FILIP_D, esm=cfg_esm)
    esm_params = esm2.init_params(cfg_esm, torch.Generator(device="cuda").manual_seed(0),
                                  dtype=torch.bfloat16, device="cuda")
    return mcfg, esm_params


def filip_first_batch(data_dir: Path, args) -> tuple:
    """(engine config, device batch) of a run's first train batch of epoch
    0, tokenized as the path tokenizes it (one bucket or length groups)."""
    mcfg, _ = filip_setup()
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=args.batch_size, accumulated_batches=1,
                                   num_chunks=args.num_chunks, length_groups=args.length_groups,
                                   packed=args.packed, packed_tiers=args.pack_tiers,
                                   scatter_tiers=args.scatter_tiers, filip_use_dcl=args.use_dcl)
    loader = dataset.PairLoader(filip_data(data_dir)[0], args.batch_size, seed=args.seed)
    loader.reseed_epoch(0)
    peps, recs = next(iter(loader))
    packed_engine.clear_tier_width_cache()          # the run's first batch: cleared caches
    return cfg, to_device(clip_engine._prepare(common.make_tokenizer(), cfg)(peps, recs), "cuda")


def filip_path_blocks(run: dict, data_dir: Path) -> list[tuple]:
    """The K4 blocks of the run's first train batch, (ha, hb, mask_a,
    mask_b) for every (group, group) pair: the tokens of the run's
    best_model.npz heads in eval mode."""
    mcfg, esm_params = filip_setup()
    heads = checkpoint.load_npz(run["run"] / "best_model.npz",
                                filip.init_params(mcfg, torch.Generator(), device="meta"), "cuda")
    _, batch = filip_first_batch(data_dir, run["args"])
    groups = [clip_engine.expand_batch(b) for b in (batch if isinstance(batch, tuple)
                                                    else (batch,))]
    with torch.no_grad():
        sides = [(*filip.encode_batch_tokens(heads, esm_params, b, mcfg), b["pep_mask"],
                  b["rec_mask"]) for b in groups]
    return [(a[0], b[1], a[2], b[3]) for a in sides for b in sides]


def end_blocks(blocks: list) -> list:
    """The first block of a step and, when it has more, its last (the
    grouped step's widest rectangle)."""
    return blocks[:1] + blocks[1:][-1:]


def tied(h: torch.Tensor) -> torch.Tensor:
    """h with every odd token a copy of the even token before it: each
    max over those tokens ties exactly, in every arithmetic."""
    out = h.clone()
    out[:, 1::2] = h[:, 0::2][:, :out[:, 1::2].shape[1]]
    return out


def filip_path_cases(blocks: list[tuple], gen: torch.Generator) -> list:
    """K4's check inputs on the FILIP path's own blocks: every block as
    the step gives it; and from the first block and the last (the grouped
    run's widest rectangle) an a-row and a b-row with no valid token;
    forced ties (tied tokens); b-row 0 cut to 65 valid tokens (a tile whose
    only valid token is its first: the skip fault); tokens at norm
    K4_SHORT_SCALE with 1-4 valid tokens a row (plain TF32)."""
    def case(label, ha, hb, ma, mb):
        return (ha.shape[0], hb.shape[0], ha.shape[1], hb.shape[1]), (ha, hb, ma, mb), label

    def short(m):
        n = torch.randint(1, 5, (m.shape[0], 1), device="cuda", generator=gen)
        return (torch.arange(m.shape[1], device="cuda")[None] < n).to(torch.int32)

    cases = [case("path block", *blk) for blk in blocks]
    for ha, hb, ma, mb in end_blocks(blocks):
        empty_a, empty_b = ma.clone(), mb.clone()
        empty_a[ma.shape[0] // 2] = 0
        empty_b[mb.shape[0] // 2] = 0
        cases.append(case("path block, empty rows", ha, hb, empty_a, empty_b))
        cases.append(case("path block, tied tokens", tied(ha), tied(hb), ma, mb))
        if hb.shape[1] > 64:
            cut = mb.clone()
            cut[0] = 0
            cut[0, :65] = 1
            cases.append(case("path block, b-row 0 of 65 tokens", ha, hb, ma, cut))
        cases.append(case("path block, short", K4_SHORT_SCALE * ha, K4_SHORT_SCALE * hb,
                          short(ma), short(mb)))
    return cases


def check_filip_path_k4(blocks: dict, fault_libs: dict, gen: torch.Generator) -> dict:
    """K4 against its plain version on both runs' blocks (filip_path_cases),
    then against its two planted faults, which must fail: the skip fault
    every case with a one-token tile, plain TF32 every short case."""
    cases = [c for blks in blocks.values() for c in filip_path_cases(blks, gen)]
    err = check_maxsim(cases)
    faults = check_maxsim_faults(fault_libs, cases)
    return {"max_abs_err": err, "cases": len(cases),
            "shapes": sorted({tuple(c[0]) for c in cases if c[2] == "path block"}),
            "fault": {k: {"worst_ratio": v["worst_ratio"], "cases_failed": v["cases_failed"]}
                      for k, v in faults.items()}}


def check_filip_backward(blocks: dict, gen: torch.Generator) -> float:
    """The max-sim backward on the card (through the wrapper's autograd
    Function: K4 forward, ops.filip.maxsim_backward) against autograd
    through maxsim_reference in float64 on the card, for random cotangents,
    on the path's first block of each run and the grouped run's last:
    tokens rounded to multiples of 1/16 and tied (every score exact in f32
    and float64, so both see the same ties, which amax also splits
    evenly), with the path's masks and with an a-row and a b-row emptied.
    Per output max|err| <= MAXSIM_BWD_RTOL max|ref|."""
    worst = 0.0
    for ha, hb, ma, mb in [b for blks in blocks.values() for b in end_blocks(blks)]:
        qa, qb = (tied(torch.round(h * 16) / 16) for h in (ha, hb))
        empty_a, empty_b = ma.clone(), mb.clone()
        empty_a[0] = 0
        empty_b[-1] = 0
        for label, (m_a, m_b) in (("path masks", (ma, mb)), ("empty rows", (empty_a, empty_b))):
            ga = torch.randn(ha.shape[0], hb.shape[0], device="cuda", generator=gen)
            gb = torch.randn(ha.shape[0], hb.shape[0], device="cuda", generator=gen)
            xa, xb = qa.clone().requires_grad_(True), qb.clone().requires_grad_(True)
            torch.autograd.backward(maxsim.filip_similarity_fused(xa, xb, m_a, m_b, 1.0),
                                    (ga, gb))
            ra, rb = qa.double().requires_grad_(True), qb.double().requires_grad_(True)
            torch.autograd.backward(maxsim.maxsim_reference(ra, rb, m_a, m_b),
                                    (ga.double(), gb.double()))
            errs = [float((x.grad.double() - r.grad).abs().max() / r.grad.abs().max())
                    for x, r in ((xa, ra), (xb, rb))]
            s = torch.einsum("atd,jsd->ajts", qa, qb)
            valid = (m_a[:, None, :, None] * m_b[None, :, None, :]) > 0
            sm = torch.where(valid, s, maxsim._NEG)
            ties = int((((sm == sm.amax(3, keepdim=True)) & valid).sum(3) > 1).sum())
            ok = max(errs) <= MAXSIM_BWD_RTOL and ties > 0
            log(f"[filip train] max-sim backward (Ba, Bb, TA, TB)="
                f"{(ha.shape[0], hb.shape[0], ha.shape[1], hb.shape[1])}, {label}, {ties} tied "
                f"row maxima: max|err| / max|ref| dha {errs[0]:.4g}, dhb {errs[1]:.4g} against "
                f"float64 autograd (tolerance {MAXSIM_BWD_RTOL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("the max-sim backward disagrees with float64 autograd")
            worst = max(worst, *errs)
    return worst


def check_filip_retrieve(run: dict, data_dir: Path) -> float:
    """embed --filip of 64 receptors with the run's best_model.npz, then
    retrieve --filip for 4 peptides: one K4 launch, hits against the plain
    max-sim at each rank."""
    mcfg, esm_params = filip_setup()
    ckpt = ["--checkpoint", str(run["run"] / "best_model.npz")]
    peps = sequences_only(data_dir / "protein1.fasta")[:4]
    recs = sequences_only(data_dir / "protein2.fasta")[:64]
    (WORK / "filip_train_index.fasta").write_text("".join(f">r{i}\n{s}\n"
                                                          for i, s in enumerate(recs)))
    (WORK / "filip_train_queries.fasta").write_text("".join(f">p{i}\n{s}\n"
                                                            for i, s in enumerate(peps)))
    index = WORK / "filip_train_index.npz"
    embed.main(ckpt + ["--filip", "--fasta", str(WORK / "filip_train_index.fasta"), "--side",
                       "rec", "--out", str(index)])
    before = maxsim.filip_similarity_fused.launches
    retrieve.main(ckpt + ["--filip", "--index", str(index), "--queries",
                          str(WORK / "filip_train_queries.fasta"), "--side", "pep", "--k", "10",
                          "--out", str(WORK / "filip_train_hits.tsv")])
    launched = maxsim.filip_similarity_fused.launches - before
    heads = checkpoint.load_npz(run["run"] / "best_model.npz",
                                filip.init_params(mcfg, torch.Generator(), device="meta"), "cuda")
    toks, mask = embed.embed_sequences_tokens(heads, esm_params, peps, "pep", mcfg,
                                              common.make_tokenizer(), torch.device("cuda"),
                                              batch_size=32, pad_batch=True)
    plain, ids = plain_filip_scores(toks, mask.sum(1), index, heads["temperature"])
    worst = max(check_hits(f"retrieve --filip (trained heads) query {q}", [h for h, _ in row],
                           [sc for _, sc in row], plain[q], ids)
                for q, row in enumerate(read_tsv(WORK / "filip_train_hits.tsv", 10)))
    if launched != scorer_blocks(len(peps), len(recs)):
        raise AssertionError(f"retrieve --filip launched filip_maxsim {launched} times")
    log(f"[filip train] retrieve --filip with the batch-10 run's best_model.npz: 4 queries over "
        f"64 receptors, {launched} filip_maxsim launch; hits within {worst:.3g} of the plain "
        f"max-sim at each rank")
    return worst


def run_filip_train_phase(fault_libs: dict, gen: torch.Generator) -> dict:
    data_dir = WORK / "filip_data"
    runs = {name: run_filip_train(name, data_dir, extra) for name, extra in FILIP_RUNS}
    recs = sequences_only(data_dir / "protein2.fasta")
    peps = sequences_only(data_dir / "protein1.fasta")
    profile = (f"{FILIP_FIXTURE_FAMILIES} families, {len(recs)} pairs, protein2 "
               f"{min(map(len, recs))}-{max(map(len, recs))} aa, protein1 "
               f"{min(map(len, peps))}-{max(map(len, peps))} aa")
    log(f"[filip train] fixture: {profile}")
    blocks = {name: filip_path_blocks(run, data_dir) for name, run in runs.items()}
    return {"runs": runs, "profile": profile, "blocks": blocks,
            "k4": check_filip_path_k4(blocks, fault_libs, gen),
            "backward_err": check_filip_backward(blocks, gen),
            "retrieve_err": check_filip_retrieve(runs["filip_10"], data_dir)}


@contextlib.contextmanager
def plain_maxsim():
    """The wrapper's autograd Function runs maxsim_reference in K4's place
    (its backward is the same) while the block runs."""
    saved = maxsim._raw_maxsim
    maxsim._raw_maxsim = maxsim.maxsim_reference
    try:
        yield
    finally:
        maxsim._raw_maxsim = saved


def filip_step(cfg, batch, heads0, maxsim_cm=contextlib.nullcontext) -> tuple:
    """One FILIP train step from heads0 (Adam lr TRAIN_LR, dropout 0.1 from
    a seeded generator): (loss, gradients by leaf, K4 launches)."""
    _, esm_params = filip_setup()
    params = clone_tree(heads0)
    state = capturing(optimizer.adam(TRAIN_LR).init(params), params)
    before = maxsim.filip_similarity_fused.launches
    with maxsim_cm():
        _, _, loss = filip_engine.make_train_step(cfg)(
            params, state, esm_params, batch, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    return float(loss), state.grads, maxsim.filip_similarity_fused.launches - before


def check_filip_step(runs: dict, data_dir: Path, fault_libs: dict) -> dict:
    """For each FILIP run's configuration, one step on its first batch
    through K4 against the same step through K4's plain version in the same
    autograd Function: the loss within FILIP_STEP_TOL relative and every
    head gradient within FILIP_STEP_TOL of the step's largest gradient
    entry (the temperature's gradient sums terms of that scale that nearly
    cancel). The step through K4 run again equals itself to the bit. The
    same step through each planted K4 fault is read (not held)."""
    mcfg, _ = filip_setup()
    heads0 = filip.init_params(mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    out = {}
    for name, run in runs.items():
        cfg, batch = filip_first_batch(data_dir, run["args"])
        blocks = cfg.length_groups ** 2
        lk, gk, nk = filip_step(cfg, batch, heads0)
        lp, gp, np_ = filip_step(cfg, batch, heads0, plain_maxsim)
        la, ga, na = filip_step(cfg, batch, heads0)
        if (nk, np_, na) != (blocks, 0, blocks):
            raise AssertionError(f"FILIP step check {name}: filip_maxsim launches {nk}, {np_}, "
                                 f"{na}; want {blocks}, 0, {blocks}")
        scale = max(float(g.abs().max()) for g in gp.values())
        gaps = {k: float((gk[k] - gp[k]).abs().max()) / scale for k in gp}
        loss_err = abs(lk - lp) / abs(lp)
        same = lk == la and all(torch.equal(gk[k], ga[k]) for k in gk)
        faults = {}
        for fault in ("maxsim_skip", "maxsim_tf32"):
            with maxsim_kernel(fault_libs[fault]["filip_maxsim"]):
                lf, gf, _ = filip_step(cfg, batch, heads0)
            faults[fault] = {"loss_ratio": abs(lf - lp) / abs(lp) / FILIP_STEP_TOL,
                             "grad_ratio": max(float((gf[k] - gp[k]).abs().max()) / scale
                                               for k in gp) / FILIP_STEP_TOL}
        ok = loss_err <= FILIP_STEP_TOL and max(gaps.values()) <= FILIP_STEP_TOL and same
        worst = max(gaps, key=gaps.get)
        log(f"[step] FILIP {name} ({cfg.length_groups} group(s), {blocks} K4 block(s), "
            f"{'DCL' if cfg.filip_use_dcl else 'no DCL'}) through filip_maxsim vs its plain "
            f"version: loss {lk:.7f} vs {lp:.7f}, relative |err| {loss_err:.3g}; gradients "
            f"max |err| / the step's largest entry {gaps[worst]:.3g} at {worst} (temperature "
            f"{gaps['temperature']:.3g}; tolerance {FILIP_STEP_TOL:g}); run again equal to the "
            f"bit: {same}; planted faults (x tolerance, loss / gradients): "
            + ", ".join(f"{k} {v['loss_ratio']:.4g} / {v['grad_ratio']:.4g}"
                        for k, v in faults.items()) + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the FILIP step through filip_maxsim ({name}) disagrees with "
                                 "the plain step or with itself")
        out[name] = {"loss_rel_err": loss_err, "grad_rel_err": gaps[worst],
                     "temperature_grad_rel_err": gaps["temperature"], "bitwise_equal": same,
                     "fault": faults}
    return out


def time_filip_train(ftctx: dict, data_dir: Path, gpu: str) -> dict:
    """Per FILIP run: pairs/s by CUDA events over the run's steps; K4 on the
    step's blocks (wrapper call by CUDA events, the kernel's device time,
    the plain version, the bound on the blocks' masks); the plain max-sim
    backward of one step's blocks (by CUDA events, host included, and its
    device time) and its share of the step; one step under
    torch.profiler: launches, K4 launches and the device's busy share."""
    out = {}
    for name, run in ftctx["runs"].items():
        a = run["args"]
        rate = time_train_steps({name: run, "profile": ftctx["profile"]}, name,
                                f"FILIP train step ({a.length_groups} length group(s), "
                                f"{a.num_chunks} chunk(s))", gpu, pairs=a.batch_size)
        step_ms = 1e3 * a.batch_size / rate
        blocks = ftctx["blocks"][name]
        rows = []
        for ha, hb, ma, mb in end_blocks(blocks):
            def call():
                return maxsim.filip_similarity_fused(ha, hb, ma, mb, 1.0)
            ms = cuda_ms(call, 50)
            kernel_ms = device_ms(call, 50, kernel="filip_maxsim_kernel")
            plain_ms = cuda_ms(lambda: maxsim.maxsim_reference(ha, hb, ma, mb), 5, warmup=1)
            bound_ms, bound_by, counts = maxsim_bound(ma, mb, FILIP_D)
            shape = [ha.shape[0], hb.shape[0], ha.shape[1], hb.shape[1], FILIP_D]
            log(f"[time] filip_maxsim on the FILIP {name} step's block {tuple(shape)}: call "
                f"{ms:.6f} ms (kernel's device time {kernel_ms:.6f}), plain {plain_ms:.6f} ms, "
                f"bound {bound_ms:.6f} ms ({bound_by}: {counts}) = {100 * bound_ms / ms:.2f}% "
                f"of the bound | {gpu}")
            rows.append({"shape": shape, "ms": ms, "device_ms": kernel_ms, "plain_ms": plain_ms,
                         "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by})
        cot = [(torch.randn(ha.shape[0], hb.shape[0], device="cuda"),
                torch.randn(ha.shape[0], hb.shape[0], device="cuda")) for ha, hb, _, _ in blocks]

        def backward():
            for (ha, hb, ma, mb), (ga, gb) in zip(blocks, cot):
                maxsim.maxsim_backward(ha, hb, ma, mb, ga, gb)
        bwd_ms = cuda_ms(backward, 10)
        bwd_device_ms = device_ms(backward, 10)
        per_step = filip_launches_per_step(run, data_dir)
        log(f"[time] the plain max-sim backward of one FILIP {name} step ({len(blocks)} "
            f"block(s)): {bwd_ms:.4f} ms by CUDA events ({bwd_device_ms:.4f} ms device time) "
            f"= {100 * bwd_ms / step_ms:.2f}% of the step's {step_ms:.4f} ms | {gpu}")
        out[name] = {"pairs_per_s": rate, "step_ms": step_ms, "k4_blocks": rows,
                     "backward_ms": bwd_ms, "backward_device_ms": bwd_device_ms,
                     "backward_share": bwd_ms / step_ms, "per_step": per_step}
    return out


def filip_launches_per_step(run: dict, data_dir: Path) -> dict:
    """Kernel launches and the device's busy share of one FILIP step (the
    run's configuration, its first batch) under torch.profiler."""
    mcfg, esm_params = filip_setup()
    cfg, batch = filip_first_batch(data_dir, run["args"])
    params = filip.init_params(mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    state = optimizer.adam(TRAIN_LR).init(params)
    step = filip_engine.make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    step(params, state, esm_params, batch, gen)                 # warm
    torch.cuda.synchronize()
    k4 = maxsim.filip_similarity_fused.launches
    kernels, wall = profiled_step(lambda: step(params, state, esm_params, batch, gen))
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k4_ms = sum(e.self_device_time_total for e in kernels if "filip_maxsim" in e.key) / 1e3
    out = {"launches": sum(e.count for e in kernels), "busy_ms": busy_ms,
           "busy_share": busy_ms / (1e3 * wall), "wall_ms": 1e3 * wall,
           "filip_maxsim": maxsim.filip_similarity_fused.launches - k4, "k4_device_ms": k4_ms}
    log(f"[time] one FILIP step (batch {cfg.batch_size}, {cfg.length_groups} group(s)) under "
        f"torch.profiler: {out['launches']} kernel launches ({out['filip_maxsim']} "
        f"filip_maxsim, {k4_ms:.4f} ms of device time), device busy {busy_ms:.4f} ms of "
        f"{out['wall_ms']:.4f} ms ({100 * out['busy_share']:.2f}%)")
    return out


# ---------------------------------------------------------------------------
# Phase 7b, the rest of FILIP training: packed FILIP with scatter tiers (K4
# on tier-pair blocks), and FILIP's finetune and LoRA modes, one bucket and
# packed (K5 in pass 2)
# ---------------------------------------------------------------------------

def filip_loaders(data_dir: Path, batch_size: int) -> tuple:
    """The train, val and test loaders of cli.main_2protein_filip's first
    epoch, as the run builds and reseeds them (the test loader keeps its
    first draws)."""
    train_ds, val_ds, test_ds = filip_data(data_dir)
    train, val, test = (dataset.PairLoader(ds, batch_size, shuffle=ds is train_ds, seed=42)
                        for ds in (train_ds, val_ds, test_ds))
    train.reseed_epoch(0)
    val.reseed_epoch(0)
    return train, val, test


def filip_k4_blocks(batch: dict) -> int:
    """K4 launches of one FILIP batch: one per (pep tier, rec tier) pair of
    tiers that hold a sequence (a scatter tier no sequence takes ships no
    rows and launches nothing; every width-tier pack, a placeholder too,
    ships at least 8 rows), or one without tiers."""
    n = 1
    for side in ("pep", "rec"):
        if f"{side}_packs" in batch:
            n *= len(batch[f"{side}_packs"])
        else:
            n *= sum(len(t["operm"]) > 0
                     for t in batch.get(f"{side}_stiers") or ({"operm": [0]},))
    return n


def filip_epoch_plan(data_dir: Path, args) -> dict:
    """What one epoch of cli.main_2protein_filip with ``args`` (one bucket or
    packed; frozen or unfrozen) launches, from its loaders' batches tokenized
    again here: the backbone forwards' (rows, L), K1 (one per layer, 30 per
    forward; the unfrozen steps 30 per pass-1 chunk and 60 per pass-2 chunk:
    forward and remat recompute), K5 (30 per pass-2 chunk) and K4
    (filip_k4_blocks per step and eval batch)."""
    train, val, test = filip_loaders(data_dir, args.batch_size)
    mcfg, _ = filip_setup()
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=args.batch_size, accumulated_batches=1,
                                   packed=args.packed, packed_tiers=args.pack_tiers,
                                   scatter_tiers=args.scatter_tiers)
    prepare = clip_engine._prepare(common.make_tokenizer(), cfg)
    packed_engine.clear_tier_width_cache()          # the run packs from cleared caches
    unfrozen = bool(args.finetune or args.lora_rank)
    n = filip_engine._snap_chunks(args.batch_size, args.num_chunks)
    layers = mcfg.esm.num_layers
    plan = {"forwards": [], "attention_fwd": 0, "attention_bwd": 0, "filip_maxsim": 0,
            "steps": 0, "evals": 0, "step_chunks": []}
    for loaders, training in (((train,), True), ((val, test), False)):
        for p, r in (pr for loader in loaders for pr in loader):
            b = prepare(p, r)
            if args.packed:
                chunks = unfrozen_chunks(b) if training and unfrozen else packed_chunks(b)
            else:
                chunks = [(args.batch_size // n, b[f"{side}_ids"].shape[1])
                          for side in ("pep", "rec") for _ in range(n)]
            passes = 2 if training and unfrozen else 1
            plan["forwards"] += chunks * passes
            plan["attention_fwd"] += (3 if passes == 2 else 1) * layers * len(chunks)
            plan["attention_bwd"] += layers * len(chunks) if passes == 2 else 0
            plan["filip_maxsim"] += filip_k4_blocks(b)
            plan["steps" if training else "evals"] += 1
            if training:
                plan["step_chunks"].append(chunks)
    return plan


def run_filip_more(name: str, data_dir: Path, extra: list[str], engine) -> dict:
    """cli.main_2protein_filip for one epoch: the artifacts, and every
    kernel's launch count and the backbone forwards against
    filip_epoch_plan; no InfoNCE kernel (FILIP's loss is plain PyTorch)."""
    runs = WORK / f"runs_{name}"
    argv = ["--synthetic-fixture", "--data-dir", str(data_dir), "--fixture-families",
            str(FILIP_FIXTURE_FAMILIES), "--epochs", "1", "--runs-dir", str(runs)] + extra
    args = filip_cli.build_argparser().parse_args(argv)
    plan = filip_epoch_plan(data_dir, args)
    t0 = time.perf_counter()
    with counted_forwards() as forwards, timed_steps(engine) as ends:
        reset_counts()
        filip_cli.main(argv)
        got = {"attention_fwd": attention.launches["attention_fwd"],
               "attention_bwd": attention.launches["attention_bwd"],
               "filip_maxsim": maxsim.filip_similarity_fused.launches}
        counts = infonce_counts()
        check_default_path(name)
    wall = time.perf_counter() - t0
    run = check_run_dir(runs)
    want = {k: plan[k] for k in got}
    if (len(ends), sorted(forwards), got) != (plan["steps"], sorted(plan["forwards"]), want) \
            or any(v != (0, 0) for v in counts.values()):
        raise AssertionError(f"{name}: {len(ends)} steps (want {plan['steps']}), "
                             f"{len(forwards)} backbone forwards (want {len(plan['forwards'])}), "
                             f"launches {got} (want {want}); InfoNCE calls {counts}")
    metrics = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    per_step = len(plan["forwards"]) and sum(map(len, plan["step_chunks"])) / plan["steps"]
    log(f"[filip train] {name} ({' '.join(extra)}): {plan['steps']} steps, {plan['evals']} eval "
        f"batches; train loss {metrics['train_loss']:.6f}, val loss {metrics['val_loss']:.6f}; "
        f"chunk forwards (rows, L) of the first step {plan['step_chunks'][0]}, {per_step:.2f} a "
        f"step (a pass), {len(forwards)} backbone forwards in all; attention_fwd "
        f"{got['attention_fwd']}, attention_bwd {got['attention_bwd']}, filip_maxsim "
        f"{got['filip_maxsim']} (as predicted from the loaders' batches); epoch "
        f"{metrics['seconds']:.2f} s, cli.main_2protein_filip {wall:.2f} s")
    return {"run": run, "args": args, "extra": extra, "steps": plan["steps"],
            "evals": plan["evals"], "ends": ends, "launches": got, "chunks_per_step": per_step}


def filip_embed_check(run: dict, data_dir: Path, what: str) -> None:
    """embed --filip of 8 receptors with the run's best_model.npz (the
    finetuned backbone, or the adapters merged into the base): finite
    tokens of dim FILIP_D."""
    fasta = WORK / "filip_more_embed.fasta"
    recs = sequences_only(data_dir / "protein2.fasta")[:8]
    fasta.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(recs)))
    embed.main(["--checkpoint", str(run["run"] / "best_model.npz"), "--filip", "--fasta",
                str(fasta), "--side", "rec", "--out", str(WORK / "filip_more_embed.npz")])
    with np.load(WORK / "filip_more_embed.npz") as index:
        tokens, lengths = index["tokens"], index["lengths"]
    if tokens.shape != (int(lengths.sum()), FILIP_D) or not np.isfinite(tokens).all():
        raise AssertionError(f"embed --filip with {what} gave {tokens.shape}")
    log(f"[filip train] embed --filip with {what}: tokens {tokens.shape}, finite")


def filip_tier_blocks(run: dict, data_dir: Path) -> list[tuple]:
    """The K4 blocks of a packed run's first train batch, (ha, hb, mask_a,
    mask_b) for every (pep tier, rec tier) pair of tiers that hold a
    sequence (or the one flat block): the tokens of the run's best heads in
    eval mode, scattered as the step scatters them, phantom rows included."""
    mcfg, esm_params = filip_setup()
    heads = checkpoint.load_npz(run["run"] / "best_model.npz",
                                filip.init_params(mcfg, torch.Generator(), device="meta"), "cuda")
    _, batch = filip_first_batch(data_dir, run["args"])
    b = packed_engine.expand_packed_batch(batch)
    n = packed_engine.packed_side_count(b, "pep")
    tiers = {}
    with torch.no_grad():
        for side in ("pep", "rec"):
            pk = {k: b[f"{side}_{k}"] for k in ("ids", "seg", "pos", "owner")}
            h = packed_engine._encode_packed_chunked(esm_params, pk["ids"], pk["seg"], pk["pos"],
                                                     mcfg.esm, 16).float()
            x = filip_packed._l2_normalize_tokens(head_mod.encode_tokens(heads[side], h,
                                                                         mcfg.activation))
            tiers[side] = filip_packed._scatter_side(x, pk, b.get(f"{side}_stiers"), n)
    return [(a[0], c[0], a[1], c[1]) for a in tiers["pep"] for c in tiers["rec"]
            if len(a[0]) and len(c[0])]


def check_filip_tier_k4(blocks: list, fault_libs: dict, gen: torch.Generator,
                        long_rows: bool = False) -> dict:
    """K4 against its plain version on the packed run's tier-pair blocks
    (filip_path_cases: as the step gives them, with their phantom rows,
    and the variants), on the first block with every a-row and then every
    b-row a sentinel (no valid token: every score 0), then against both
    planted faults, which must fail their cases. With ``long_rows`` (width
    tiers' rows up to 2048 tokens) the skip fault must fail the case made
    for it, b-row 0 cut to 65 tokens: a natural row of some 2000 tokens
    holds a one-token tile whose lone token carries a max only by chance,
    so the fault can stay under K4_ATOL there (0.0298 x on the long-tail
    fixture, H100), and those readings are printed."""
    cases = filip_path_cases(blocks, gen)
    ha, hb, ma, mb = blocks[0]
    shape = (ha.shape[0], hb.shape[0], ha.shape[1], hb.shape[1])
    cases += [(shape, (ha, hb, torch.zeros_like(ma), mb), "tier block, a-tier of sentinels only"),
              (shape, (ha, hb, ma, torch.zeros_like(mb)), "tier block, b-tier of sentinels only")]
    err = check_maxsim(cases)
    faults = check_maxsim_faults(fault_libs, cases, (lambda r: r["label"].endswith("65 tokens"))
                                 if long_rows else None)
    phantom = sum(int((m.sum(1) == 0).sum()) for blk in blocks for m in blk[2:])
    log(f"[filip train] K4 on {len(blocks)} tier-pair blocks of the packed run's first batch "
        f"({phantom} all-masked rows among them), {len(cases)} cases: max|err| {err:.3g}")
    return {"max_abs_err": err, "cases": len(cases), "phantom_rows": phantom,
            "shapes": sorted({tuple(c[0]) for c in cases if c[2] == "path block"}),
            "fault": {k: {"worst_ratio": v["worst_ratio"], "cases_failed": v["cases_failed"]}
                      for k, v in faults.items()}}


TIE_SPLIT_LINE = "pa = pa / pa.sum(3, keepdim=True).clamp(min=1.0)"


@contextlib.contextmanager
def uneven_tie_split():
    """The planted fault of the max-sim backward, which is plain PyTorch: a
    patched copy of ops.filip.maxsim_backward whose a-side max hands its
    whole gradient to every tied token, not an even share, runs in the
    wrapper's backward while the block runs."""
    src = textwrap.dedent(inspect.getsource(maxsim.maxsim_backward))
    if src.count(TIE_SPLIT_LINE) != 1:
        raise AssertionError("the uneven tie split fault: its line is not in maxsim_backward")
    scope = dict(vars(maxsim))
    exec(compile(src.replace(TIE_SPLIT_LINE, "pa = pa"), maxsim.__file__, "exec"), scope)
    saved = maxsim.maxsim_backward
    maxsim.maxsim_backward = scope["maxsim_backward"]
    try:
        yield
    finally:
        maxsim.maxsim_backward = saved


def check_filip_tier_backward(blocks: list, gen: torch.Generator) -> dict:
    """The max-sim backward on the packed step's first and last tier-pair
    blocks, tokens rounded to 1/16 and tied (every score exact, the same
    ties in every arithmetic), with the path's masks and with an a-row and
    a b-row emptied, for random cotangents: the f32 backward through the
    wrapper (K4 forward, ops.filip.maxsim_backward) against float64
    autograd through maxsim_reference, per output max|err| <=
    MAXSIM_TIER_BWD_RTOL max|ref|; the same with uneven_tie_split must fail
    every case; and, a second witness of the split, maxsim_backward on
    float64 tokens within MAXSIM_BWD_RTOL."""
    worst32 = worst64 = 0.0
    fault_min = math.inf
    for ha, hb, ma, mb in end_blocks(blocks):
        qa, qb = (tied(torch.round(h * 16) / 16) for h in (ha, hb))
        empty_a, empty_b = ma.clone(), mb.clone()
        empty_a[0] = 0
        empty_b[-1] = 0
        for label, (m_a, m_b) in (("path masks", (ma, mb)), ("empty rows", (empty_a, empty_b))):
            ga = torch.randn(ha.shape[0], hb.shape[0], device="cuda", generator=gen)
            gb = torch.randn(ha.shape[0], hb.shape[0], device="cuda", generator=gen)
            ra, rb = qa.double().requires_grad_(True), qb.double().requires_grad_(True)
            torch.autograd.backward(maxsim.maxsim_reference(ra, rb, m_a, m_b),
                                    (ga.double(), gb.double()))

            def rel(a, b):
                return float((a.double() - b).abs().max() / b.abs().max())

            def wrapper_grads():
                xa, xb = qa.clone().requires_grad_(True), qb.clone().requires_grad_(True)
                torch.autograd.backward(maxsim.filip_similarity_fused(xa, xb, m_a, m_b, 1.0),
                                        (ga, gb))
                return max(rel(x.grad, r.grad) for x, r in ((xa, ra), (xb, rb)))

            e32 = wrapper_grads()
            with uneven_tie_split():
                fault = wrapper_grads()
            got64 = maxsim.maxsim_backward(qa.double(), qb.double(), m_a, m_b, ga.double(),
                                           gb.double())
            e64 = max(rel(g, r.grad) for g, r in zip(got64, (ra, rb)))
            ok = e32 <= MAXSIM_TIER_BWD_RTOL < fault and e64 <= MAXSIM_BWD_RTOL
            log(f"[filip train] max-sim backward on the tier block (Ba, Bb, TA, TB)="
                f"{(ha.shape[0], hb.shape[0], ha.shape[1], hb.shape[1])}, {label}: max|err| / "
                f"max|ref| against float64 autograd, f32 through the wrapper {e32:.4g} "
                f"(tolerance {MAXSIM_TIER_BWD_RTOL:.4g}), the uneven tie split {fault:.4g} "
                f"(must exceed it), float64 {e64:.4g} (tolerance {MAXSIM_BWD_RTOL:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("the max-sim backward disagrees with float64 autograd on a "
                                     "tier block, or the check misses an uneven tie split")
            worst32, worst64 = max(worst32, e32), max(worst64, e64)
            fault_min = min(fault_min, fault)
    return {"f32_max_rel_err": worst32, "float64_max_rel_err": worst64,
            "uneven_tie_split_min_rel_err": fault_min}


def filip_chunk_segments(runs: dict, data_dir: Path) -> list[tuple[str, torch.Tensor]]:
    """The segment ids of the last chunk of each side that K1 and K5 take on
    the packed unfrozen FILIP step's first batch (the constant-token rule),
    and that K1 takes on the frozen packed step's (16 rows a chunk)."""
    out = []
    for name, shapes in (("filip_finetune_packed", unfrozen_chunk_shapes),
                         ("filip_packed_128", lambda b: [(chunk_rows(b[f"{s}_ids"].shape[0]),)
                                                         for s in ("pep", "rec")])):
        _, batch = filip_first_batch(data_dir, runs[name]["args"])
        for side, (rows, *_) in zip(("pep", "rec"), shapes(batch)):
            seg = packed_engine.derive_segments(batch[f"{side}_ids"])[1][-rows:].contiguous()
            out.append((f"packed, {name} {side} chunk, {int((seg.amax(1) == 0).sum())} rows all "
                        "<pad>", seg))
    return out


def check_filip_chunks(segments: list, gen: torch.Generator) -> dict:
    """K1 (with its statistics) and K5 (fed them) against their plain
    versions on the FILIP packed paths' own chunks, at K1's tolerance form."""
    k1 = check_attention([(*seg.shape, kind, True, *qkv(*seg.shape, gen), seg)
                          for kind, seg in segments])
    cases = []
    for kind, seg in segments[:2]:                      # the unfrozen step's chunks
        q, k, v = qkv(*seg.shape, gen)
        do = torch.randn(*seg.shape, NH, DH, device="cuda", generator=gen).bfloat16()
        cases.append((*seg.shape, kind, True, q, k, v, do, seg))
    return {"attention_fwd": k1, "attention_bwd": check_attention_bwd(cases),
            "shapes": [list(seg.shape) for _, seg in segments]}


def run_filip_more_phase(fault_libs: dict, gen: torch.Generator) -> dict:
    data_dir = WORK / "filip_data"
    if not (data_dir / "protein1.fasta").exists():       # phase 7 writes it
        write_fixture(data_dir, prefix1="protein1", prefix2="protein2",
                      n_families=FILIP_FIXTURE_FAMILIES, seed=42)
    runs = {name: run_filip_more(name, data_dir, extra, engine)
            for name, extra, engine in FILIP_MORE_RUNS}
    for name in ("filip_finetune_packed", "filip_lora_packed"):
        filip_embed_check(runs[name], data_dir, f"the {name} run's best_model.npz")
    blocks = filip_tier_blocks(runs["filip_packed_128"], data_dir)
    return {"runs": runs, "blocks": blocks,
            "flat_block": filip_tier_blocks(runs["filip_packed_128_flat"], data_dir),
            "k4": check_filip_tier_k4(blocks, fault_libs, gen),
            "backward": check_filip_tier_backward(blocks, gen),
            "chunks": check_filip_chunks(filip_chunk_segments(runs, data_dir), gen)}


def check_filip_packed_step(runs: dict, data_dir: Path, fault_libs: dict) -> dict:
    """One packed FILIP step (batch 128, 4 scatter tiers, the run's first
    batch, dropout 0.1 from a seeded generator) through K4 against the same
    step through K4's plain version: the loss within FILIP_STEP_TOL relative,
    every head gradient within FILIP_STEP_TOL of the step's largest entry;
    run again, equal to the bit; against the same pairs at one scatter tier
    (one flat block): the loss within FILIP_STEP_TOL relative. The planted
    K4 faults are read, not held."""
    mcfg, _ = filip_setup()
    heads0 = filip.init_params(mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    cfg, batch = filip_first_batch(data_dir, runs["filip_packed_128"]["args"])
    cfg1, batch1 = filip_first_batch(data_dir, runs["filip_packed_128_flat"]["args"])
    blocks = filip_k4_blocks(batch)
    lk, gk, nk = filip_step(cfg, batch, heads0)
    lp, gp, np_ = filip_step(cfg, batch, heads0, plain_maxsim)
    la, ga, na = filip_step(cfg, batch, heads0)
    l1, g1, n1 = filip_step(cfg1, batch1, heads0)
    if (nk, np_, na, n1) != (blocks, 0, blocks, 1):
        raise AssertionError(f"packed FILIP step check: filip_maxsim launches {nk}, {np_}, {na}, "
                             f"{n1}; want {blocks}, 0, {blocks}, 1")
    scale = max(float(g.abs().max()) for g in gp.values())
    gaps = {k: float((gk[k] - gp[k]).abs().max()) / scale for k in gp}
    flat_gaps = {k: float((gk[k] - g1[k]).abs().max()) / scale for k in gp}
    loss_err, flat_err = abs(lk - lp) / abs(lp), abs(lk - l1) / abs(l1)
    same = lk == la and all(torch.equal(gk[k], ga[k]) for k in gk)
    faults = {}
    for fault in ("maxsim_skip", "maxsim_tf32"):
        with maxsim_kernel(fault_libs[fault]["filip_maxsim"]):
            lf, gf, _ = filip_step(cfg, batch, heads0)
        faults[fault] = {"loss_ratio": abs(lf - lp) / abs(lp) / FILIP_STEP_TOL,
                         "grad_ratio": max(float((gf[k] - gp[k]).abs().max()) / scale
                                           for k in gp) / FILIP_STEP_TOL}
    worst = max(gaps, key=gaps.get)
    ok = max(loss_err, gaps[worst], flat_err) <= FILIP_STEP_TOL and same
    log(f"[step] packed FILIP at batch 128, {blocks} tier-pair K4 blocks, through filip_maxsim "
        f"vs its plain version: loss {lk:.7f} vs {lp:.7f}, relative |err| {loss_err:.3g}; "
        f"gradients max |err| / the step's largest entry {gaps[worst]:.3g} at {worst} "
        f"(tolerance {FILIP_STEP_TOL:g}); run again equal to the bit: {same}; at one scatter "
        f"tier (one flat block) loss {l1:.7f}, relative |err| {flat_err:.3g}, gradients "
        f"{max(flat_gaps.values()):.3g}; planted faults (x tolerance, loss / gradients): "
        + ", ".join(f"{k} {v['loss_ratio']:.4g} / {v['grad_ratio']:.4g}" for k, v in faults.items())
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the packed FILIP step through filip_maxsim disagrees with the plain "
                             "step, with itself or with the flat scatter")
    return {"blocks": blocks, "loss_rel_err": loss_err, "grad_rel_err": gaps[worst],
            "flat_loss_rel_err": flat_err, "flat_grad_rel_err": max(flat_gaps.values()),
            "bitwise_equal": same, "fault": faults}


def filip_finetune_steps(cfg, batch, paths: tuple, fault_libs: dict) -> dict:
    """One FILIP finetune step per path from the same f32 master (t30_150M's
    seeded weights) and FILIP heads, dropout 0: {path: (loss, {leaf:
    gradient})}. "kernel" (and "again") run K1 and K5, "k1_plain_bwd" K1
    and K5's plain version, "fault" K1 and the swept_tiles build of K5 (its
    dk/dv loop drops the last query tile). K1, K5 and K4 must launch as
    filip_epoch_plan predicts for the batch."""
    mcfg, esm0 = filip_setup()
    heads0 = filip.init_params(mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    chunks = (len(unfrozen_chunks(batch)) if cfg.packed
              else 2 * filip_engine._snap_chunks(cfg.batch_size, cfg.num_chunks))
    layers = mcfg.esm.num_layers
    k1, k5 = attention._forward, attention.fused_attention_bwd
    out = {"chunks": chunks}
    run_cfg = dataclasses.replace(cfg, model=dataclasses.replace(mcfg, dropout=0.0))
    for path in paths:
        want = (3 * layers * chunks, 0 if path == "k1_plain_bwd" else layers * chunks,
                filip_k4_blocks(batch))
        params = finetune.init_params(esm0, clone_tree(heads0))
        state = capturing(filip_finetune.make_optimizer(run_cfg).init(params), params)
        before = (attention.launches["attention_fwd"], attention.launches["attention_bwd"],
                  maxsim.filip_similarity_fused.launches)
        faulty = (attention_kernels(fault_libs["swept_tiles"], ("attention_bwd",))
                  if path == "fault" else contextlib.nullcontext())
        t0 = time.perf_counter()
        with attention_function(k1, plain_backward if path == "k1_plain_bwd" else k5), faulty:
            _, _, loss = filip_finetune.make_train_step(run_cfg)(params, state, {}, batch, None)
        torch.cuda.synchronize()
        log(f"[timing] FILIP finetune step run {path} (batch {cfg.batch_size}"
            f"{', packed' if cfg.packed else ''}): {time.perf_counter() - t0:.1f} s")
        calls = (attention.launches["attention_fwd"] - before[0], attention.launches["attention_bwd"] - before[1],
                 maxsim.filip_similarity_fused.launches - before[2])
        if calls != want:
            raise AssertionError(f"FILIP finetune step ({path}): (attention_fwd, attention_bwd, "
                                 f"filip_maxsim) launches {calls}, want {want}")
        out[path] = (float(loss), state.grads)
        del params, state
    return out


def k5_step_readings(steps: dict) -> dict:
    """Per leaf, in units of FT_K5_TOL times the leaf's largest entry of the
    step through K5's plain version, how far the step through K5 ("kernel")
    and through its swept-tile fault ("fault", where it ran) sit from it
    (check_finetune_step's form)."""
    plain = steps["k1_plain_bwd"][1]
    return {path: {k: float((steps[path][1][k] - plain[k]).abs().max())
                   / float(plain[k].abs().max()) / FT_K5_TOL for k in plain}
            for path in ("kernel", "fault") if path in steps}


def top(ratios: dict, n: int = 3) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in sorted(ratios.items(), key=lambda kv: -kv[1])[:n])


def check_filip_unfrozen_step(runs: dict, data_dir: Path, fault_libs: dict) -> dict:
    """K5 inside the FILIP finetune step, one bucket and packed, at the run's
    own batch (64) and at global batch FILIP_FT_CHECK_BATCH, on the
    fixture's first batch (dropout 0): check_finetune_step's form, the step
    through K1/K5 against the step through K1 and K5's plain version, every
    leaf within FILIP_FT_K5_TOL of its largest entry (printed in units of
    FT_K5_TOL, the CLIP check's limit, which the FILIP step exceeds: see
    FILIP_FT_K5_TOL) and the loss within FT_LOSS_TOL relative. At FILIP_FT_CHECK_BATCH K5's
    swept-tile fault must fail it, and the step equals itself to the bit."""
    out = {}
    limit = FILIP_FT_K5_TOL / FT_K5_TOL
    for name in ("filip_finetune", "filip_finetune_packed"):
        args = runs[name]["args"]
        big_args = argparse.Namespace(**{**vars(args), "batch_size": FILIP_FT_CHECK_BATCH,
                                         "num_chunks": FILIP_FT_CHECK_BATCH // 32})
        row = {"limit_in_ft_k5_tol": limit}
        for batch_size, run_args, paths in (
                (args.batch_size, args, ("kernel", "k1_plain_bwd")),
                (FILIP_FT_CHECK_BATCH, big_args, ("kernel", "again", "k1_plain_bwd", "fault"))):
            cfg, batch = filip_first_batch(data_dir, run_args)
            steps = filip_finetune_steps(cfg, batch, paths, fault_libs)
            r = k5_step_readings(steps)
            worst = max(r["kernel"], key=r["kernel"].get)
            (lk, gk), (lp, _) = steps["kernel"], steps["k1_plain_bwd"]
            loss_err = abs(lk - lp) / abs(lp)
            ok = r["kernel"][worst] <= limit and loss_err <= FT_LOSS_TOL
            line = (f"[step] FILIP finetune {name}, batch {batch_size} ({steps['chunks']} chunks "
                    f"a pass; dropout 0) through K1/K5 vs K1 and K5's plain version: loss "
                    f"{lk:.7f} vs {lp:.7f}, relative {loss_err:.3g} (tolerance {FT_LOSS_TOL:g}); "
                    f"per leaf max|err| / leaf max over FT_K5_TOL {FT_K5_TOL:g}: "
                    f"{top(r['kernel'])} (limit {limit:g}: FILIP_FT_K5_TOL {FILIP_FT_K5_TOL:g})")
            if "fault" in r:
                worst_fault = max(r["fault"], key=r["fault"].get)
                same = steps["again"][0] == lk and all(
                    torch.equal(steps["again"][1][k], gk[k]) for k in gk)
                ok = ok and r["fault"][worst_fault] > limit and same
                line += (f"; the planted fault (K5 built to drop the last query tile of dk/dv): "
                         f"{r['fault'][worst_fault]:.4g} ({worst_fault}); run twice equal to "
                         f"the bit: {same}")
                row.update(fault_ratio=r["fault"][worst_fault], fault_leaf=worst_fault,
                           bitwise_equal=same)
            log(f"{line} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the FILIP finetune step {name} at batch {batch_size} "
                                     "through K1/K5 disagrees with K5's plain version, differs "
                                     "from itself, or misses the planted fault")
            row[f"batch_{batch_size}"] = {"chunks": steps["chunks"], "loss_rel_err": loss_err,
                                          "grad_ratio": r["kernel"][worst], "grad_leaf": worst}
        out[name] = row
    return out


def filip_step_profile(run: dict, data_dir: Path, engine) -> dict:
    """Kernel launches, busy share and peak memory of one step of a run's
    configuration on its first batch under torch.profiler (engine:
    filip_engine, or filip_finetune with an f32 master)."""
    mcfg, esm_params = filip_setup()
    cfg, batch = filip_first_batch(data_dir, run["args"])
    params = filip.init_params(mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    if engine is filip_finetune:
        params, esm_params = filip_finetune.init_params(esm_params, params), {}
        state = filip_finetune.make_optimizer(cfg).init(params)
    else:
        state = optimizer.adam(TRAIN_LR).init(params)
    step = engine.make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    step(params, state, esm_params, batch, gen)                 # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k4 = maxsim.filip_similarity_fused.launches
    kernels, wall = profiled_step(lambda: step(params, state, esm_params, batch, gen))
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3

    def share(name):
        return sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3

    out = {"launches": sum(e.count for e in kernels), "busy_ms": busy_ms,
           "busy_share": busy_ms / (1e3 * wall), "wall_ms": 1e3 * wall,
           "filip_maxsim": maxsim.filip_similarity_fused.launches - k4,
           "k4_device_ms": share("filip_maxsim"), "k1_device_ms": share("attention_fwd"),
           "k5_device_ms": share("attention_bwd"),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[time] one {run['args'].batch_size}-pair step of {' '.join(run['extra'])} under "
        f"torch.profiler: {out['launches']} kernel launches ({out['filip_maxsim']} filip_maxsim, "
        f"{out['k4_device_ms']:.4f} ms; K1 {out['k1_device_ms']:.4f} ms, K5 "
        f"{out['k5_device_ms']:.4f} ms of device time), device busy {busy_ms:.4f} ms of "
        f"{out['wall_ms']:.4f} ms ({100 * out['busy_share']:.2f}%); peak memory "
        f"{out['peak_memory_gb']:.4f} GB")
    return out


def time_tier_blocks(blocks: list, what: str, gpu: str) -> dict:
    """K4 over one step's blocks (one launch each), by CUDA events and by
    device time, the plain version over the same blocks, and the bound of
    the blocks' work summed (maxsim_work: allowed pairs, valid tokens)."""
    def call():
        for ha, hb, ma, mb in blocks:
            maxsim.filip_similarity_fused(ha, hb, ma, mb, 1.0)

    def plain():
        for ha, hb, ma, mb in blocks:
            maxsim.maxsim_reference(ha, hb, ma, mb)

    ms = cuda_ms(call, 20)
    kernel_ms = device_ms(call, 20, kernel="filip_maxsim_kernel")
    plain_ms = cuda_ms(plain, 3, warmup=1)
    work = [maxsim_work(ma, mb, FILIP_D) for _, _, ma, mb in blocks]
    t_ops = sum(w["flops"] for w in work) / H100_TF32_FLOPS
    t_bytes = sum(w["bytes"] for w in work) / H100_BYTES_PER_S
    bound_ms, bound_by = 1e3 * max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations"
    shapes = [[ha.shape[0], hb.shape[0], ha.shape[1], hb.shape[1]] for ha, hb, _, _ in blocks]
    log(f"[time] filip_maxsim over {what} ({len(blocks)} block(s) {shapes}, D={FILIP_D}): calls "
        f"{ms:.6f} ms (kernels' device time {kernel_ms:.6f}), plain {plain_ms:.6f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}: {sum(w['flops'] for w in work) / 1e9:.4f} GFLOP over "
        f"{sum(w['pairs'] for w in work):.6g} allowed pairs, "
        f"{sum(w['bytes'] for w in work) / 1e6:.4f} MB) = {100 * bound_ms / ms:.2f}% of the "
        f"bound | {gpu}")
    return {"shapes": shapes, "ms": ms, "device_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


def time_filip_more(fmctx: dict, data_dir: Path, gpu: str, profile: str) -> dict:
    """Per run: pairs/s by CUDA events over its steps; K4 over the packed
    step's tier-pair blocks and over the flat step's one block against the
    bound; one packed frozen and one packed finetune step under
    torch.profiler (launches, busy share, peak memory)."""
    out = {}
    for name, run in fmctx["runs"].items():
        out[name] = {"pairs_per_s": time_train_steps(
            {name: run, "profile": profile}, name, f"FILIP {' '.join(run['extra'])} step", gpu,
            pairs=run["args"].batch_size)}
    out["filip_packed_128"]["k4_tier_blocks"] = time_tier_blocks(
        fmctx["blocks"], "the packed step's tier-pair blocks", gpu)
    out["filip_packed_128_flat"]["k4_flat_block"] = time_tier_blocks(
        fmctx["flat_block"], "the flat packed step's block", gpu)
    out["filip_packed_128"]["per_step"] = filip_step_profile(fmctx["runs"]["filip_packed_128"],
                                                             data_dir, filip_engine)
    out["filip_finetune_packed"]["per_step"] = filip_step_profile(
        fmctx["runs"]["filip_finetune_packed"], data_dir, filip_finetune)
    return out


# ---------------------------------------------------------------------------
# Phase 7c: resume (train-state snapshots) and the offline evals
# ---------------------------------------------------------------------------

# (name, CLI, data, fixture families, argv): cli.main --packed --finetune on
# the 1000-family fixture (two steps an epoch at global batch 256: f32
# master backbone, two Adam groups, K1/K5/K2) and cli.main_2protein_filip
# --packed at batch 128 on the FILIP fixture (six steps an epoch: the
# fixture's val split holds one batch of 128, not of 385; K4 under a
# gradient)
RESUME_RUNS = (
    ("resume_finetune_packed", train_cli, ONE_BUCKET_DATA, ONE_BUCKET_FIXTURE_FAMILIES,
     ["--packed", "--finetune"]),
    ("resume_filip_packed", filip_cli, "filip_data", FILIP_FIXTURE_FAMILIES,
     ["--batch-size", "128", "--packed"]))


@contextlib.contextmanager
def counted_evals():
    """The wrappers' launches of each clip_engine.evaluate call (fit's
    validation per epoch, then its test evaluation) while the block runs."""
    calls: list[dict] = []
    plain = clip_engine.evaluate

    def counted(*args, **kwargs):
        before = counts()
        out = plain(*args, **kwargs)
        calls.append({k: v - before[k] for k, v in counts().items()})
        return out

    clip_engine.evaluate = counted
    try:
        yield calls
    finally:
        clip_engine.evaluate = plain


def resume_run(cli, argv: list[str], epochs: int, runs: Path | None = None,
               resume_dir: Path | None = None) -> dict:
    """One CLI training run: its run directory, every wrapper's launches,
    each evaluate call's launches, and its wall seconds."""
    where = ["--resume-dir", str(resume_dir)] if resume_dir else ["--runs-dir", str(runs)]
    t0 = time.perf_counter()
    with counted_evals() as evals:
        reset_counts()
        cli.main(argv + ["--epochs", str(epochs)] + where)
        launches = counts()
    run = resume_dir or next(iter(runs.iterdir()))
    return {"run": run, "launches": launches, "evals": evals,
            "seconds": time.perf_counter() - t0}


def run_resume_phase() -> dict:
    """Each of RESUME_RUNS three times: two epochs unbroken; one epoch; then
    --epochs 2 --resume-dir on the second run's directory. The resumed run's
    epoch-2 CSV row, its metrics.jsonl losses, its best_model.npz and its
    final snapshot must equal the unbroken run's to the bit (the steps
    repeat to the bit); one snapshot is left in state/; and every kernel's
    launch count in the resumed run, less its test evaluation, equals the
    unbroken run's less the one-epoch run's (the resumed epoch's count),
    the test evaluation the same in all three."""
    out = {}
    for name, cli, data, families, extra in RESUME_RUNS:
        argv = ["--synthetic-fixture", "--data-dir", str(WORK / data), "--fixture-families",
                str(families)] + extra
        full = resume_run(cli, argv, 2, WORK / f"runs_{name}_full")
        first = resume_run(cli, argv, 1, WORK / f"runs_{name}_split")
        resumed = resume_run(cli, argv, 2, resume_dir=first["run"])
        rows = [(r["run"] / "losses_per_epoch.txt").read_text().splitlines()
                for r in (full, resumed)]
        metrics = [[(m["epoch"], m["train_loss"], m["val_loss"]) for m in map(
            json.loads, (r["run"] / "metrics.jsonl").read_text().splitlines())]
            for r in (full, resumed)]
        best = [checkpoint.read_npz(r["run"] / "best_model.npz") for r in (full, resumed)]
        snaps = [sorted(p.name for p in (r["run"] / "state").iterdir()) for r in (full, resumed)]
        states = [checkpoint.load_train_state(r["run"] / "state" / "epoch_2.pt", "cpu")
                  for r in (full, resumed)]
        same = {"csv": rows[0] == rows[1] and len(rows[0]) == 3,
                "metrics": metrics[0] == metrics[1] and len(metrics[0]) == 2,
                "best_model": best[0].keys() == best[1].keys()
                and all(np.array_equal(best[0][k], best[1][k]) for k in best[0]),
                "snapshot": snaps == [["epoch_2.pt"]] * 2 and same_state(*states)}
        tests = [r["evals"][-1] for r in (full, first, resumed)]
        epoch2 = {k: full["launches"][k] - first["launches"][k] for k in full["launches"]}
        grew = {k: resumed["launches"][k] - tests[2][k] for k in epoch2}
        kernels = {k: v for k, v in epoch2.items() if v}
        log(f"[resume] {name} ({' '.join(extra)}): unbroken 2 epochs {full['seconds']:.2f} s, "
            f"1 epoch {first['seconds']:.2f} s, resumed to 2 {resumed['seconds']:.2f} s; epoch 2 "
            f"rows {rows[0][2]!r} and {rows[1][2]!r}; equal to the bit: {same}; snapshots left "
            f"{snaps}; launches of epoch 2 (unbroken less one epoch) {kernels}, of the resumed "
            f"run less its test evaluation "
            f"{ {k: v for k, v in grew.items() if v} }; test evaluation the same in all three: "
            f"{tests[0] == tests[1] == tests[2]}")
        if not all(same.values()):
            raise AssertionError(f"{name}: the resumed run differs from the unbroken one: {same}")
        if grew != epoch2 or not (tests[0] == tests[1] == tests[2]) or not kernels:
            raise AssertionError(f"{name}: the resumed epoch's launches {grew} against {epoch2}")
        out[name] = {"bitwise_equal": same, "launches": kernel_counts(resumed["launches"]),
                     "epoch_2_launches": kernel_counts(epoch2), "seconds": {
                         "unbroken": full["seconds"], "one_epoch": first["seconds"],
                         "resumed": resumed["seconds"]}}
        for r in (full, resumed):
            shutil.rmtree(r["run"] / "state")
    return out


def same_state(a, b) -> bool:
    """Two train-state snapshots hold the same tensors and numbers."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


@contextlib.contextmanager
def captured(module, name: str):
    """Keep the arguments and result of each call of module.name while the
    block runs."""
    calls: list[tuple] = []
    plain = getattr(module, name)

    def capture(*args, **kwargs):
        out = plain(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, capture)
    try:
        yield calls
    finally:
        setattr(module, name, plain)


def run_eval(cli, argv: list[str], runs: Path, capture: tuple = ()) -> dict:
    """One offline eval CLI call: its printed lines, its run directory,
    every wrapper's launches, and what ``capture`` (module, name) kept."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        kept = stack.enter_context(captured(*capture)) if capture else None
        reset_counts()
        with contextlib.redirect_stdout(buf):
            cli.main(argv + ["--runs-dir", str(runs)])
        launches = counts()
    print(buf.getvalue(), end="", flush=True)
    printed = {line.split(":")[0]: line for line in buf.getvalue().splitlines()
               if line.startswith(("top-1 accuracy", "top-10 accuracy", "mean rank"))}
    return {"printed": printed, "run": next(iter(runs.iterdir())), "kept": kept,
            "launches": {k: v for k, v in launches.items() if v},
            "seconds": time.perf_counter() - t0}


def near_ties(scores: np.ndarray, eps: float) -> np.ndarray:
    """Per query, the candidates whose score lies within 2 eps of its true
    partner's: the only ones whose order against it a difference of eps in
    every score can change."""
    gap = np.abs(scores - np.diag(scores)[:, None])
    np.fill_diagonal(gap, np.inf)
    return (gap <= 2 * eps).sum(axis=1)


def check_printed(got: dict, ranks: np.ndarray, n: int) -> None:
    """cli.topk's three printed lines against the ranks it was given."""
    curve = retrieval.topk_curve(ranks, n)
    want = [f"top-1 accuracy: {curve[0]:.4f}", f"top-10 accuracy: {curve[9]:.4f}",
            f"mean rank: {ranks.mean():.1f} / {n}"]
    if sorted(got.values()) != sorted(want):
        raise AssertionError(f"cli.topk printed {got}, its ranks give {want}")


def run_eval_phase(clip_ckpt: Path, filip_ckpt: Path) -> dict:
    """cli.topk at --n-candidates 256 on the 3000-family fixture's val split
    with a CLIP run's best_model.npz, padded and --packed, and with --filip
    on the FILIP fixture's train split with a FILIP run's; then
    cli.cosine_similarity with the CLIP checkpoint. The padded and packed
    ranks agree but at near-ties: a query's ranks may differ by at most its
    candidates within twice the largest logit difference of the two
    embeddings (which agree per row at cosine >= COSINE_MIN); --filip's
    ranks, through K4, equal those of the plain max-sim's scores on the
    same tokens but at such near-ties, and its scores are within K4_ATOL of
    them. Launches: K1 once a layer per backbone forward (32 padded, one per
    packed chunk), K4 once per 64-query block, K1 30 per heatmap forward;
    no other kernel."""
    n = 256
    clip_data, filip_data = WORK / "train_data", WORK / "filip_data"
    clip_argv = ["--checkpoint", str(clip_ckpt), "--synthetic-fixture", "--data-dir",
                 str(clip_data), "--fixture-families", str(FIXTURE_FAMILIES), "--prefix-a",
                 "peptide", "--prefix-b", "receptor"]
    padded = run_eval(topk, clip_argv + ["--n-candidates", str(n)], WORK / "runs_topk",
                      (retrieval, "encode_candidates"))
    packed = run_eval(topk, clip_argv + ["--n-candidates", str(n), "--packed"],
                      WORK / "runs_topk_packed", (retrieval, "encode_candidates"))
    fil = run_eval(topk, ["--checkpoint", str(filip_ckpt), "--synthetic-fixture", "--data-dir",
                          str(filip_data), "--fixture-families", str(FILIP_FIXTURE_FAMILIES),
                          "--split", "train", "--n-candidates", str(n), "--filip"],
                   WORK / "runs_topk_filip", (retrieval, "filip_score_matrix"))
    FIGURES["apart"] = False
    try:
        cos = run_eval(cosine_similarity, clip_argv, WORK / "runs_cosine")
    finally:
        FIGURES["apart"] = True
    out = {name: {"launches": r["launches"], "seconds": r["seconds"], "printed": r["printed"]}
           for name, r in (("topk", padded), ("topk_packed", packed), ("topk_filip", fil),
                           ("cosine_similarity", cos))}

    # padded against packed
    (_, _, (p1, r1)), = padded["kept"]
    (_, _, (p2, r2)), = packed["kept"]
    cos_min = min(float(row_cosines(a, b).min()) for a, b in ((p1, p2), (r1, r2)))
    l1, l2 = (np.asarray(p, np.float64) @ np.asarray(r, np.float64).T for p, r in ((p1, r1),
                                                                                   (p2, r2)))
    eps = float(np.abs(l1 - l2).max())
    rank1, rank2 = (retrieval.ranks_from_embeddings(p, r) for p, r in ((p1, r1), (p2, r2)))
    ties = near_ties(l1, eps)
    moved = np.abs(rank1 - rank2)
    check_printed(padded["printed"], rank1, n)
    check_printed(packed["printed"], rank2, n)
    ok = cos_min >= COSINE_MIN and bool((moved <= ties).all())
    log(f"[eval] cli.topk padded against --packed on the same {n} pairs: embeddings per row "
        f"cosine min {cos_min:.6f} (>= {COSINE_MIN}); logits max |difference| {eps:.3g}; "
        f"{int((moved > 0).sum())} queries ranked apart (by up to {int(moved.max())}), "
        f"{int((ties > 0).sum())} queries with a candidate within 2x that of the true partner "
        f"({int(ties.sum())} such candidates); every rank change within them: "
        f"{bool((moved <= ties).all())}; top-1 {padded['printed']['top-1 accuracy']!r} / "
        f"{packed['printed']['top-1 accuracy']!r} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cli.topk --packed ranks disagree with the padded ones past their "
                             "near-ties")
    out["topk_packed"].update(cos_min=cos_min, logit_max_abs_diff=eps,
                              queries_ranked_apart=int((moved > 0).sum()),
                              near_tie_candidates=int(ties.sum()))

    # --filip through K4 against the plain max-sim
    (args, kwargs, s_k4), = fil["kept"]
    ha, ma, hb, mb, temperature = args[:5]
    sa, sb = maxsim.maxsim_reference(ha, hb, ma, mb)
    s_plain = ((sa + sb) / 2 / maxsim.clamped_temperature(temperature)).cpu().numpy()
    eps = float(np.abs(s_k4 - s_plain).max())
    rank_k4 = 1 + (s_k4 > np.diag(s_k4)[:, None]).sum(axis=1)
    rank_plain = 1 + (s_plain > np.diag(s_plain)[:, None]).sum(axis=1)
    ties = near_ties(s_plain, eps)
    moved = np.abs(rank_k4 - rank_plain)
    check_printed(fil["printed"], rank_k4, n)
    ok = eps <= K4_ATOL and bool((moved <= ties).all())
    log(f"[eval] cli.topk --filip: scores through filip_maxsim against the plain max-sim on "
        f"the same tokens (256 x 256, TA {ha.shape[1]}, TB {hb.shape[1]}): max |difference| "
        f"{eps:.3g} (<= {K4_ATOL:g}); {int((moved > 0).sum())} queries ranked apart, "
        f"{int(ties.sum())} near-tie candidates; every rank change within them: "
        f"{bool((moved <= ties).all())} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cli.topk --filip disagrees with the plain max-sim")
    out["topk_filip"].update(score_max_abs_diff=eps, queries_ranked_apart=int((moved > 0).sum()),
                             near_tie_candidates=int(ties.sum()))

    # cosine_similarity's matrices
    matrices = sorted((cos["run"] / "figures").glob("*.npy"))
    values = [np.load(f) for f in matrices]
    if len(values) != 3 or not all(np.isfinite(m).all() and np.abs(m).max() <= 1 + 1e-6
                                   for m in values):
        raise AssertionError(f"cli.cosine_similarity wrote {[f.name for f in matrices]}")
    log(f"[eval] cli.cosine_similarity: {[f.name for f in matrices]}, each {values[0].shape}, "
        f"finite, |value| <= {max(float(np.abs(m).max()) for m in values):.6f} (<= 1 + 1e-6)")

    # launches: the backbone forwards and K4 blocks each path takes
    train_ds, val_ds, _ = dataset.generate_datasets(clip_data, seed=42)
    peps, recs = retrieval._collect_pairs(dataset.PairLoader(val_ds, 16, shuffle=False, seed=42),
                                          n)
    chunks = len(packed_chunks(packed_engine.tokenize_packed(common.make_tokenizer(), peps,
                                                             recs)))
    want = {"topk": {"attention:attention_fwd": 30 * 32},
            "topk_packed": {"attention:attention_fwd": 30 * chunks},
            "topk_filip": {"attention:attention_fwd": 30 * 32, "filip_maxsim": n // 64},
            "cosine_similarity": {"attention:attention_fwd": 30 * 6}}
    for name, w in want.items():
        if out[name]["launches"] != w:
            raise AssertionError(f"{name}: launches {out[name]['launches']}, want {w}")
    log(f"[eval] launches as the paths predict: " + "; ".join(
        f"{name} {out[name]['launches']}" for name in want)
        + f" (cli.topk --packed: {chunks} chunk forwards); seconds: " + ", ".join(
            f"{name} {out[name]['seconds']:.2f}" for name in want))
    return out


# ---------------------------------------------------------------------------
# Phase 8: one train step through K2 / K3 against the plain loss
# ---------------------------------------------------------------------------

def capturing(state, params):
    """Make ``state.apply`` keep, by leaf name, the gradients it applies."""
    named = checkpoint._flatten(params)
    apply = state.apply

    def capture():   # FILIP's steps give emb_ffn, which they do not read, no gradient
        state.grads = {k: t.grad.detach().clone() for k, t in named.items()
                       if t.grad is not None}
        apply()

    state.apply = capture
    return state


def clone_tree(tree):
    return {k: clone_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def step_readings(pool: int, packed: bool = False, family: str = "t30_150M") -> dict:
    """One frozen train step at global batch ``pool`` through K2 or K3 (by
    clip_engine's rule) and through the plain loss, from the same heads and
    batch (4 length groups, or with ``packed`` one packed batch): the loss
    within 1e-5 relative and the gradients within 1e-5 of each leaf's
    largest. Adam's first update is lr g / (|g| + eps): when g
    moves by dg it moves by at most 2 lr |dg| / (max|g| + eps), which near
    g = 0 turns f32 noise into up to lr; each updated parameter is held to
    that bound plus 1e-6, and the count beyond a flat 1e-5 is printed.
    Returns the readings and whether they are within the limits ("ok").
    The backbone is ``family`` (t30_150M) in bf16."""
    cfg_esm = common.esm_config(family, "bfloat16")
    mcfg = clip.CLIPConfig(input_dim=cfg_esm.hidden_size, dropout=0.0, esm=cfg_esm)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=pool // 16, accumulated_batches=16,
                                   length_groups=4, packed=packed)
    esm_params = esm2.init_params(cfg_esm, torch.Generator(device="cuda").manual_seed(0),
                                  dtype=torch.bfloat16, device="cuda")
    data_dir = WORK / "train_data"
    if not (data_dir / "receptor.fasta").exists():
        write_fixture(data_dir, n_families=FIXTURE_FAMILIES, seed=42)
    train_ds, _, _ = dataset.generate_datasets(data_dir, seed=42)
    loader = dataset.PairLoader(train_ds, pool // 16, seed=SEED)
    peps, recs = next(clip_engine._accumulate(loader, 16))
    batch = to_device(clip_engine._prepare(common.make_tokenizer(), cfg)(peps, recs), "cuda")
    heads0 = clip.init_params(mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    kernel = loss_kernel(pool)
    kernel_fn = getattr(infonce, "fused_infonce" if kernel == "infonce"
                        else "fused_infonce_tiled")
    out = {}
    for name, loss_fn in (("kernel", None), ("plain", infonce.clip_infonce)):
        params = clone_tree(heads0)
        state = capturing(optimizer.adam(TRAIN_LR).init(params), params)
        before = (kernel_fn.launches, kernel_fn.bwd_launches)
        _, _, loss = clip_engine.make_train_step(cfg, loss_fn)(params, state, esm_params, batch,
                                                                None)
        torch.cuda.synchronize()
        calls = (kernel_fn.launches - before[0], kernel_fn.bwd_launches - before[1])
        if calls != ((1, 1) if name == "kernel" else (0, 0)):
            raise AssertionError(f"step check {pool}: {kernel} calls {calls} ({name})")
        out[name] = (float(loss), list(state.grads.values()), [t.detach() for t in state.leaves])
    (lk, gk, pk), (lp, gp, pp) = out["kernel"], out["plain"]
    loss_err = abs(lk - lp) / abs(lp)
    grad_err = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(gk, gp))
    param_err, over_bound, over_flat, n = 0.0, 0, 0, 0
    for a, b, ga, gb in zip(pk, pp, gk, gp):
        d = (a - b).abs()
        bound = 1e-6 + 2 * TRAIN_LR * (ga - gb).abs() / (torch.maximum(ga.abs(), gb.abs()) + 1e-8)
        param_err = max(param_err, float(d.max()))
        over_bound += int((d > bound).sum())
        over_flat += int((d > 1e-5).sum())
        n += d.numel()
    ok = loss_err <= 1e-5 and grad_err <= 1e-5 and over_bound == 0
    log(f"[step] {family} global batch {pool}{' packed' if packed else ''} through {kernel} vs "
        f"the plain loss (dropout 0, Adam "
        f"lr {TRAIN_LR:g}): loss {lk:.6f} vs {lp:.6f}, relative |err| {loss_err:.3g} (tolerance "
        f"1e-5); gradients max |err| / leaf max {grad_err:.3g} (tolerance 1e-5); updated "
        f"params max |err| {param_err:.3g}, {over_bound} of {n} past Adam's bound, {over_flat} "
        f"past a flat 1e-5 {'ok' if ok else 'FAIL'}")
    return {"kernel": kernel, "loss_rel_err": loss_err, "grad_rel_err": grad_err,
            "param_max_abs_err": param_err, "over_bound": over_bound, "ok": ok}


def check_step(pool: int, packed: bool = False, family: str = "t30_150M") -> dict:
    """step_readings, which must be within their limits."""
    r = step_readings(pool, packed, family)
    if not r["ok"]:
        raise AssertionError(f"the {'packed ' if packed else ''}train step through "
                             f"{r['kernel']} disagrees with the plain loss")
    return {k: r[k] for k in ("loss_rel_err", "grad_rel_err", "param_max_abs_err")}


def plain_forward(q, k, v, segments, with_lse=False):
    """K1's plain versions in K1's place (ops.attention._forward)."""
    out = attention.attention_reference(q, k, v, segments)
    return (out, attention.attention_reference_lse(q, k, segments)) if with_lse else out


def plain_backward(q, k, v, segments, do, lse, out=None):
    """K5's plain version in K5's place: it recomputes what lse (and, in
    f32, out) holds."""
    return attention.attention_reference_bwd(q, k, v, segments, do)


@contextlib.contextmanager
def attention_function(forward, backward):
    """The fused attention Function with another forward (K1's place) and
    backward (K5's place) while the block runs."""
    saved = attention._forward, attention.fused_attention_bwd
    attention._forward, attention.fused_attention_bwd = forward, backward
    try:
        yield
    finally:
        attention._forward, attention.fused_attention_bwd = saved


def finetune_step_runs(fault_libs: dict, packed: bool = False, family: str = "t30_150M",
                       pool: int = 256, names: tuple | None = None,
                       dtype: torch.dtype = torch.bfloat16, activation: str = "relu") -> dict:
    """One finetune step of ``family`` (t30_150M) at global batch ``pool``
    (256; one pad bucket in 16 chunks, or with ``packed`` the packed step
    over the same pairs; remat, dropout 0, the two-group Adam) from the same
    f32 master weights and batch, once per attention path (``names``, by
    default all below that apply): {name: (loss, {leaf: gradient})}.
    "kernel" runs K1 and K5; "k1_plain_bwd" K1 and K5's plain version;
    "fault" K1
    and the swept_tiles planted-fault build of K5 (its dk/dv loop drops
    the last query tile); "eager" and "eager_f32"
    attention_impl="eager" (plain attention through autograd) with a bf16
    and an f32 backbone; "gated", "gated_again", "gated_fault" and
    "gated_tf32" run "kernel" under PCT_FFN_PALLAS=1 (K6 in the backbone's
    dtype once a layer per chunk forward and remat recompute; "gated_fault"
    and "gated_tf32" through the ffn_f32_k_tile and ffn_f32_tf32
    planted-fault builds of K6-f32); "gated_reordered" runs the gate with
    reordered_dense_gelu in place of the kernel (no K6 launch); and
    "plain_fwd_k5" K1's plain version and K5, "plain" both plain versions
    (the TPU kernels' semantics, rounding where they round), readings that
    no check holds. These are run only when ``names`` asks for them.
    ``activation`` is the heads' FFN activation (CLIPConfig's; relu by
    default). The packed step runs "kernel" twice ("again"). With ``dtype``
    float32 the
    fused runs take an f32 backbone through K1-f32 and K5-f32 (their plain
    versions, their fault)."""
    f32 = dtype == torch.float32
    base = common.esm_config(family, "float32" if f32 else "bfloat16")
    L = base.num_layers
    esm0 = esm2.init_params(base, torch.Generator(device="cuda").manual_seed(0),
                            dtype=dtype, device="cuda")
    data_dir = WORK / "train_data"
    if not (data_dir / "receptor.fasta").exists():
        write_fixture(data_dir, n_families=FIXTURE_FAMILIES, seed=42)
    train_ds, _, _ = dataset.generate_datasets(data_dir, seed=42)
    peps, recs = next(clip_engine._accumulate(dataset.PairLoader(train_ds, pool // 16,
                                                                 seed=SEED), 16))
    tokenize = packed_engine.tokenize_packed if packed else clip_engine.tokenize_pair_batch
    batch = to_device(tokenize(common.make_tokenizer(), peps, recs), "cuda")
    heads0 = clip.init_params(clip.CLIPConfig(input_dim=base.hidden_size, esm=base),
                              torch.Generator().manual_seed(SEED), device="cuda")
    k1, k5 = attention._forward, attention.fused_attention_bwd
    plain_fwd, plain_bwd = plain_forward, plain_backward
    c = len(unfrozen_chunks(batch)) if packed else 2 * 16       # chunks per pass
    runs = (("kernel", "fused", dtype, k1, k5, (3 * L * c, L * c)),
            ("again", "fused", dtype, k1, k5, (3 * L * c, L * c)),
            ("k1_plain_bwd", "fused", dtype, k1, plain_bwd, (3 * L * c, 0)),
            ("plain_fwd_k5", "fused", dtype, plain_fwd, k5, (0, L * c)),
            ("plain", "fused", dtype, plain_fwd, plain_bwd, (0, 0)),
            ("fault", "fused", dtype, k1, k5, (3 * L * c, L * c)),
            ("eager", "eager", torch.bfloat16, k1, k5, (0, 0)),
            ("eager_f32", "eager", torch.float32, k1, k5, (0, 0)),
            ("gated", "fused", dtype, k1, k5, (3 * L * c, L * c)),
            ("gated_again", "fused", dtype, k1, k5, (3 * L * c, L * c)),
            ("gated_fault", "fused", dtype, k1, k5, (3 * L * c, L * c)),
            ("gated_tf32", "fused", dtype, k1, k5, (3 * L * c, L * c)),
            ("gated_reordered", "fused", dtype, k1, k5, (3 * L * c, L * c)))
    gated = ("gated", "gated_again", "gated_fault", "gated_tf32", "gated_reordered")
    gated_faults = {"gated_fault": "ffn_f32_k_tile", "gated_tf32": "ffn_f32_tf32"}
    skipped = ("plain_fwd_k5", "plain", *gated) + (() if packed else ("again",))
    if names is not None:
        skipped = tuple(run[0] for run in runs if run[0] not in names)
    out = {"shapes": (unfrozen_chunks(batch) if packed else
                      (tuple(batch["pep_ids"].shape), tuple(batch["rec_ids"].shape)))}
    for name, impl, dtype, fwd, bwd, want in runs:
        if name in skipped:
            continue
        esm_cfg = dataclasses.replace(base, attention_impl=impl, compute_dtype=dtype)
        cfg = clip_engine.EngineConfig(
            model=clip.CLIPConfig(input_dim=base.hidden_size, dropout=0.0,
                                  activation=activation, esm=esm_cfg),
            batch_size=pool // 16, accumulated_batches=16, packed=packed)
        params = finetune.init_params(esm0, clone_tree(heads0))
        state = capturing(finetune.make_optimizer(cfg).init(params), params)
        counted = [attention._kernel(n, dtype) for n in ("attention_fwd", "attention_bwd")]
        before = [attention.launches[n] for n in counted]
        ffn_before = dict(ffn.launches)
        faulty = (attention_kernels(fault_libs["swept_tiles"],
                                    (attention._kernel("attention_bwd", dtype),))
                  if name == "fault" else
                  ffn_kernels(fault_libs[gated_faults[name]]) if name in gated_faults
                  else ffn_forward(reordered_dense_gelu) if name == "gated_reordered"
                  else contextlib.nullcontext())
        t0 = time.perf_counter()
        with attention_function(fwd, bwd), faulty, \
                ffn_gate() if name in gated else contextlib.nullcontext():
            _, _, loss = finetune.make_train_step(cfg)(params, state, {}, batch, None)
        torch.cuda.synchronize()
        log(f"[timing] finetune step run {name}{' packed' if packed else ''} ({family}, "
            f"{pool}): {time.perf_counter() - t0:.1f} s")
        calls = tuple(attention.launches[n] - b for n, b in zip(counted, before))
        k6 = {n: ffn.launches[n] - b for n, b in ffn_before.items()}
        want_k6 = dict.fromkeys(ffn.launches, 0)
        if name in gated and name != "gated_reordered":
            want_k6[ffn.KERNELS[dtype]] = want[0]
        if calls != want or k6 != want_k6:
            raise AssertionError(f"finetune step check ({name}): (attention_fwd, "
                                 f"attention_bwd) launches {calls}, want {want}; ffn {k6}, "
                                 f"want {want_k6}")
        out[name] = (float(loss), state.grads)
        del params, state
        gc.collect()   # capturing() closes a cycle through the state: free it now
    return out


def leaf_gaps(a: dict, b: dict) -> dict:
    """{leaf: (max|a - b| / max|b|, |a - b| / |b| in L2)} over b's leaves."""
    return {k: (float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-30),
                float((a[k] - b[k]).norm()) / max(float(b[k].norm()), 1e-30)) for k in b}


def gap_summary(gaps: dict) -> dict:
    """Per part (backbone "esm/", heads "heads/"): the leaf with the largest
    max-relative gap, and the median and largest L2-relative gap."""
    out = {}
    for part in ("esm/", "heads/"):
        leaves = {k: v for k, v in gaps.items() if k.startswith(part)}
        worst = max(leaves, key=lambda k: leaves[k][0])
        out[part[:-1]] = {"max_rel": leaves[worst][0], "leaf": worst,
                          "l2_median": statistics.median(v[1] for v in leaves.values()),
                          "l2_max": max(v[1] for v in leaves.values())}
    return out


def check_finetune_step(fault_libs: dict, packed: bool = False) -> dict:
    """K5 inside the finetune step (one pad bucket, or with ``packed`` the
    packed step, which must also repeat to the bit), and the port's
    attention against eager autograd (finetune_step_runs).

    1. K5 in the step: "kernel" against "k1_plain_bwd". Both run K1's
       forward, so the loss and the heads' gradients agree exactly, and the
       backbone's gradients differ only by K5 against its plain version:
       the order of f32 sums before P and dS are rounded to bf16. Every
       leaf within FT_K5_TOL of its largest entry (four bf16 ulps, see
       there), the loss within
       FT_LOSS_TOL relative. The planted fault (K5 built with its dk/dv loop
       dropping the last query tile) must fail this; its largest ratio to
       the limit is printed.
    2. The port's attention against eager autograd, which rounds elsewhere
       (P to bf16 before P.V, and dP rather than dS to bf16 in the
       backward): per leaf |g_kernel - g_eager| <= 2 |g_eager - g_f32| +
       FT_GRAD_FLOOR max|g_f32|, the loss alike with FT_LOSS_FLOOR. With
       random weights the attention is near uniform, where bf16 rounds a
       row's probabilities alike, and a head bias whose gradient is small
       beside its sensitivity to the hidden states moves by a third of its
       largest entry between the bf16 and the f32 step: a check of the
       semantics, where 1 checks the kernel.
    Each path's distance from the f32 step (K1 and K5, K1 and K5's plain
    version, eager) is printed beside them."""
    out = finetune_step_runs(fault_libs, packed)
    what = "packed finetune" if packed else "finetune"
    grads = {k: v[1] for k, v in out.items() if k != "shapes"}
    loss = {k: v[0] for k, v in out.items() if k != "shapes"}
    pairs = tuple((a, b) for a, b in (
        ("kernel", "k1_plain_bwd"), ("fault", "k1_plain_bwd"), ("kernel", "plain_fwd_k5"),
        ("kernel", "eager"), ("plain", "eager"), ("kernel", "eager_f32"),
        ("k1_plain_bwd", "eager_f32"), ("plain_fwd_k5", "eager_f32"), ("plain", "eager_f32"),
        ("eager", "eager_f32")) if a in grads and b in grads)
    gaps = {f"{a}_vs_{b}": leaf_gaps(grads[a], grads[b]) for a, b in pairs}
    summary = {name: {"loss_rel": abs(loss[a] - loss[b]) / abs(loss[b]),
                      **gap_summary(gaps[name])}
               for name, (a, b) in zip(gaps, pairs)}
    for name, row in summary.items():
        log(f"[step] {what} {name}: loss relative {row['loss_rel']:.3g}; " + "; ".join(
            f"{part} max|err|/leaf max {row[part]['max_rel']:.4g} ({row[part]['leaf']}), L2 "
            f"relative median {row[part]['l2_median']:.4g}, largest {row[part]['l2_max']:.4g}"
            for part in ("esm", "heads")))
    # 1. K5 against its plain version inside the step, and the planted fault
    tight = {k: v[0] / FT_K5_TOL for k, v in gaps["kernel_vs_k1_plain_bwd"].items()}
    fault = {k: v[0] / FT_K5_TOL for k, v in gaps["fault_vs_k1_plain_bwd"].items()}
    worst, worst_fault = max(tight, key=tight.get), max(fault, key=fault.get)
    loss_k5 = summary["kernel_vs_k1_plain_bwd"]["loss_rel"]
    ok1 = tight[worst] <= 1.0 and loss_k5 <= FT_LOSS_TOL
    # 2. against eager autograd, per leaf, with the f32 step as the anchor
    (lk, gk), (le, ge), (lf, gf) = out["kernel"], out["eager"], out["eager_f32"]
    loss_allowed = 2 * abs(le - lf) + FT_LOSS_FLOOR * abs(lf)
    ratios = {}
    for key in gf:
        err = float((gk[key] - ge[key]).abs().max())
        allowed = (2 * float((ge[key] - gf[key]).abs().max())
                   + FT_GRAD_FLOOR * float(gf[key].abs().max()))
        ratios[key] = err / allowed if allowed > 0 else (0.0 if err == 0 else math.inf)
    worst_eager = max(ratios, key=ratios.get)
    ok2 = abs(lk - le) <= loss_allowed and ratios[worst_eager] <= 1.0
    shapes = (f"chunk forwards a pass {out['shapes']}" if packed else
              f"pep {out['shapes'][0]}, rec {out['shapes'][1]}")
    # 3. the packed step run twice from the same state: the same loss and gradients
    same = (not packed or (loss["again"] == lk
                           and all(torch.equal(grads["again"][k], gk[k]) for k in gk)))
    log(f"[step] {what} step at global batch 256 ({shapes}; dropout 0): loss "
        f"through K1/K5 {lk:.6f}, K1 and K5's plain version {loss['k1_plain_bwd']:.6f}, eager "
        f"{le:.6f}, eager f32 {lf:.6f}. K5 against its plain version in the step: loss "
        f"relative {loss_k5:.3g} (tolerance {FT_LOSS_TOL:g}), largest max|err|/leaf max over "
        f"the tolerance {FT_K5_TOL:g}: {tight[worst]:.4g} ({worst}); the planted fault (K5 "
        f"built to drop the last query tile of dk/dv): {fault[worst_fault]:.4g} ({worst_fault}) "
        f"{'ok' if ok1 else 'FAIL'}. Against eager: |loss - eager| {abs(lk - le):.3g} "
        f"(allowed {loss_allowed:.3g}), largest gradient ratio to 2|eager - f32| + "
        f"{FT_GRAD_FLOOR:g} max|f32|: {ratios[worst_eager]:.4g} ({worst_eager}) "
        f"{'ok' if ok2 else 'FAIL'}"
        + (f". Run twice: loss and gradients {'equal' if same else 'DIFFER'} to the bit"
           if packed else ""))
    if not ok1:
        raise AssertionError(f"K5 in the {what} step disagrees with its plain version")
    if fault[worst_fault] <= 1.0:
        raise AssertionError(f"the {what} step check does not see a K5 that drops a query tile")
    if not ok2:
        raise AssertionError(f"the {what} step through K1/K5 disagrees with the eager step")
    if not same:
        raise AssertionError(f"the {what} step is not deterministic")
    return {"loss_rel_err": loss_k5, "grad_ratio": tight[worst], "grad_leaf": worst,
            "fault_ratio": fault[worst_fault], "fault_leaf": worst_fault,
            "eager_loss_abs_err": abs(lk - le), "eager_loss_allowed": loss_allowed,
            "eager_grad_ratio": ratios[worst_eager], "eager_grad_leaf": worst_eager,
            "gaps": summary}


# ---------------------------------------------------------------------------
# Phase 7d: pretrained ESM-2 from a HF directory, f32 serving and training
# ---------------------------------------------------------------------------

def write_safetensors(path: Path, tensors: dict[str, np.ndarray]) -> None:
    """A .safetensors file of f32 arrays: the 8-byte little-endian header
    length, the JSON header ({name: {dtype, shape, data_offsets}}) padded
    with spaces to 8 bytes, then the arrays' little-endian bytes in order."""
    header, offset = {}, 0
    for key, arr in tensors.items():
        header[key] = {"dtype": "F32", "shape": list(arr.shape),
                       "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for arr in tensors.values():
            f.write(np.ascontiguousarray(arr, "<f4").tobytes())


def write_hf_dir(path: Path, cfg: esm2.ESM2Config, seed: int) -> dict[str, np.ndarray]:
    """An EsmForMaskedLM-style checkpoint directory of ``cfg`` with seeded
    f32 weights (numpy): config.json and a model.safetensors holding the
    backbone under ``esm.``-prefixed keys beside what the reader must skip
    (the MLM head, the contact head, each layer's rotary inv_freq). Returns
    the backbone's arrays by key without the prefix."""
    rng = np.random.default_rng(seed)
    backbone = {}
    for key, shape in esm2.hf_shapes(cfg).items():
        if "LayerNorm.weight" in key or "layer_norm_after.weight" in key:
            backbone[key] = (1.0 + 0.02 * rng.standard_normal(shape)).astype(np.float32)
        else:
            backbone[key] = (0.02 * rng.standard_normal(shape)).astype(np.float32)
    H, V = cfg.hidden_size, cfg.vocab_size
    skipped = {"lm_head.dense.weight": (H, H), "lm_head.dense.bias": (H,),
               "lm_head.layer_norm.weight": (H,), "lm_head.layer_norm.bias": (H,),
               "lm_head.bias": (V,),
               "esm.contact_head.regression.weight": (1, cfg.num_layers * cfg.num_heads),
               "esm.contact_head.regression.bias": (1,)}
    tensors = {f"esm.{k}": v for k, v in backbone.items()}
    tensors.update({k: rng.standard_normal(shape).astype(np.float32)
                    for k, shape in skipped.items()})
    inv_freq = (1.0 / 10000.0 ** (np.arange(0, cfg.head_dim, 2) / cfg.head_dim)).astype(np.float32)
    tensors.update({f"esm.encoder.layer.{i}.attention.self.rotary_embeddings.inv_freq": inv_freq
                    for i in range(cfg.num_layers)})
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps({
        "architectures": ["EsmForMaskedLM"], "model_type": "esm", "hidden_size": H,
        "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size, "vocab_size": V,
        "position_embedding_type": "rotary", "token_dropout": True, "pad_token_id": 1,
        "mask_token_id": 32, "layer_norm_eps": cfg.layer_norm_eps, "torch_dtype": "float32"}))
    write_safetensors(path / "model.safetensors", tensors)
    return backbone


def run_hf_phase(gpu: str) -> dict:
    """t30_150M as an EsmForMaskedLM directory of seeded weights
    (write_hf_dir): the reader (checkpoint.read_hf_checkpoint) returns the
    backbone's arrays and nothing else, to the bit; load_esm's f32 tree on
    the card holds each written array where the TPU layout puts it (linear
    weights transposed, layers stacked), to the bit; the port's
    convert_esm_weights writes an npz that loads to the same tree."""
    cfg = common.esm_config("t30_150M", "float32")
    hf_dir, npz = WORK / "hf_t30_150M", WORK / "esm_t30_150M_from_hf.npz"
    t0 = time.perf_counter()
    written = write_hf_dir(hf_dir, cfg, SEED + 5)
    t_write = time.perf_counter() - t0
    sd = checkpoint.read_hf_checkpoint(hf_dir)
    t_read = time.perf_counter() - t0 - t_write
    if set(sd) != set(written) or not all(np.array_equal(sd[k], written[k]) for k in written):
        raise AssertionError("read_hf_checkpoint does not return the written backbone")
    args = argparse.Namespace(esm_weights=str(hf_dir), esm_dtype="float32")
    tree = common.load_esm(args, cfg, torch.device("cuda"))
    for path, name, transpose in esm2._HF_LAYER_LEAVES:
        got = tree["layers"][path[0]][path[1]][path[2]].cpu().numpy()
        for i in range(cfg.num_layers):
            want = written[f"encoder.layer.{i}.{name}"]
            if not np.array_equal(got[i], want.T if transpose else want):
                raise AssertionError(f"layer {i} {name} is not the written array")
    for got, key in ((tree["embed"]["word"], "embeddings.word_embeddings.weight"),
                     (tree["final_ln"]["w"], "encoder.emb_layer_norm_after.weight"),
                     (tree["final_ln"]["b"], "encoder.emb_layer_norm_after.bias")):
        if not np.array_equal(got.cpu().numpy(), written[key]):
            raise AssertionError(f"{key} is not the written array")
    convert_esm_weights.main(["--hf", str(hf_dir), "--out", str(npz), "--config", "t30_150M"])
    from_npz = common.load_esm(argparse.Namespace(esm_weights=str(npz), esm_dtype="float32"),
                               cfg, torch.device("cuda"))
    flat, flat_npz = checkpoint._flatten(tree), checkpoint._flatten(from_npz)
    if flat.keys() != flat_npz.keys() or not all(torch.equal(flat[k], flat_npz[k]) for k in flat):
        raise AssertionError("convert_esm_weights' npz does not load to the directory's tree")
    del from_npz, flat_npz
    peaks = hf_load_peaks(hf_dir, npz)
    size = (hf_dir / "model.safetensors").stat().st_size
    log(f"[hf] t30_150M EsmForMaskedLM directory of seeded f32 weights ({size / 1e6:.1f} MB "
        f"safetensors, {len(written)} backbone tensors beside the MLM and contact heads and "
        f"{cfg.num_layers} inv_freq) written in {t_write:.1f} s, read by hand in {t_read:.1f} s: "
        f"the backbone's arrays and nothing else, to the bit; load_esm --esm-dtype float32 on "
        f"the card: every leaf the written array (transposed, stacked) to the bit; "
        f"convert_esm_weights -> {npz.name} loads to the same tree to the bit")
    return {"dir": hf_dir, "npz": npz, "esm_params": tree, "cfg": cfg,
            "safetensors_mb": size / 1e6, "read_s": t_read, "bf16_load_peaks": peaks}


def hf_load_peaks(hf_dir: Path, npz: Path) -> dict:
    """load_esm --esm-dtype bfloat16 of the f32 HF directory and of its f32
    npz: the same tree to the bit, and the card's peak allocation during
    the directory's load no higher than during the npz's (both cast on the
    host and move the bf16 tree once)."""
    cfg = common.esm_config("t30_150M", "bfloat16")
    out, trees = {}, {}
    for name, path in (("hf_dir", hf_dir), ("npz", npz)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trees[name] = checkpoint._flatten(common.load_esm(
            argparse.Namespace(esm_weights=str(path), esm_dtype="bfloat16"), cfg,
            torch.device("cuda")))
        torch.cuda.synchronize()
        out[name] = torch.cuda.max_memory_allocated() - base
    tree_bytes = sum(t.numel() * t.element_size() for t in trees["npz"].values())
    same = trees["hf_dir"].keys() == trees["npz"].keys() and all(
        torch.equal(trees["hf_dir"][k], trees["npz"][k]) for k in trees["npz"])
    log(f"[hf] load_esm --esm-dtype bfloat16: the card's peak allocation during the load "
        f"{out['hf_dir'] / 1e6:.3f} MB from the HF directory, {out['npz'] / 1e6:.3f} MB from "
        f"its npz (the bf16 tree {tree_bytes / 1e6:.3f} MB); trees "
        f"{'equal' if same else 'DIFFERENT'} to the bit")
    if not same or out["hf_dir"] > out["npz"]:
        raise AssertionError("the bf16 load of the HF directory differs from, or holds more "
                             "on the card than, the load of its npz")
    return {**out, "tree_bytes": tree_bytes}


def embed_wire(base: str, seqs: list[str], side: str) -> np.ndarray:
    """/embed through the binary wire: the served f32 bytes."""
    headers, body = call(base, "/embed", {"sequences": seqs, "side": side},
                         {"Accept": "application/octet-stream"})
    shape = tuple(int(d) for d in headers["X-Shape"].split(","))
    return np.frombuffer(body, "<f4").reshape(shape)


def start_server(argv: list[str]) -> dict:
    server = serve.make_server(serve.build_argparser().parse_args(argv))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return {"base": f"http://127.0.0.1:{server.server_address[1]}", "server": server,
            "thread": thread}


def run_f32_serve_phase(ctx: dict, hctx: dict, rng: np.random.Generator, gpu: str) -> dict:
    """cli.serve --esm-dtype float32 --esm-weights <the HF directory> with
    phase 3's heads and index: /healthz, /embed of one sequence and of 32
    (50-299 aa); K1-f32 30 times per backbone forward and no bf16 K1; the
    embeddings against the same sequences encoded in f32 with
    attention_impl="eager" on the same weights (cosine >= F32_COSINE_MIN
    per row); then the same requests to a server of the converted npz:
    equal to the bit. /embed p50 and batch-32 seqs/s."""
    cfg = hctx["cfg"]
    mcfg = clip.CLIPConfig(input_dim=cfg.hidden_size, esm=cfg)
    common_args = ["--checkpoint", str(WORK / "best_model.npz"), "--esm-dtype", "float32",
                   "--batch-size", "32", "--index", str(WORK / "index.npz"), "--port", "0"]
    one, batch32 = synthetic_seqs(rng, [100]), ctx["batch32"]
    with counted_forwards() as forwards:
        reset_counts()
        sctx = start_server(common_args + ["--esm-weights", str(hctx["dir"])])
        try:
            health = json.loads(call(sctx["base"], "/healthz")[1])
            if not (health["status"] == "ok" and health["index_size"] == 256):
                raise AssertionError(f"f32 /healthz {health}")
            got = {"one": embed_wire(sctx["base"], one, "rec"),
                   "batch32": embed_wire(sctx["base"], batch32, "rec")}
            k1, k1_bf16 = attention.launches["attention_fwd_f32"], attention.launches["attention_fwd"]
            n_forwards = len(forwards)
            if (not forwards or k1 != cfg.num_layers * n_forwards or k1_bf16
                    or dense_mm.mm.launches or any(ffn.launches.values())):
                raise AssertionError(f"f32 serve: attention_fwd_f32 {k1} for {n_forwards} "
                                     f"forwards (want {cfg.num_layers} each), attention_fwd "
                                     f"{k1_bf16}, dense_mm {dense_mm.mm.launches}, ffn "
                                     f"{ffn.launches}")
            heads = checkpoint.load_npz(WORK / "best_model.npz", clip.abstract_params(mcfg))
            eager = dataclasses.replace(mcfg, esm=dataclasses.replace(cfg, attention_impl="eager"))
            tok = common.make_tokenizer()
            cos = np.concatenate([row_cosines(got[key], embed.embed_sequences(
                heads, hctx["esm_params"], seqs, "rec", eager, tok, torch.device("cuda"),
                batch_size=32, pad_batch=True)) for key, seqs in (("one", one),
                                                                 ("batch32", batch32))])
            cos_min = float(cos.min())
            log(f"[f32 serve] /healthz {health}; /embed of 1 and of 32 sequences: {n_forwards} "
                f"backbone forwards, attention_fwd_f32 {k1} = {cfg.num_layers} per forward, bf16 "
                f"attention_fwd 0; against eager f32 attention on the same weights, 33 rows: "
                f"min cosine {cos_min:.9f}, 1 - min {1 - cos_min:.3g} (need <= "
                f"{1 - F32_COSINE_MIN:g})")
            if not 1 - cos_min <= 1 - F32_COSINE_MIN:
                raise AssertionError(f"f32 serving drifts from eager f32: cosine {cos_min}")
            times = time_serving({**sctx, "heads": heads, "esm_params": hctx["esm_params"],
                                  "mcfg": mcfg, "batch32": batch32}, rng, gpu, "f32 (HF dir)")
        finally:
            stop(sctx)
        nctx = start_server(common_args + ["--esm-weights", str(hctx["npz"])])
        try:
            same = all(np.array_equal(embed_wire(nctx["base"], seqs, "rec"), got[key])
                       for key, seqs in (("one", one), ("batch32", batch32)))
        finally:
            stop(nctx)
    log(f"[f32 serve] the same /embed requests to a server of the converted npz: "
        f"{'equal' if same else 'DIFFERENT'} to the bit")
    if not same:
        raise AssertionError("/embed from the HF directory and from its npz differ")
    return {"launches": {"attention_fwd_f32": k1}, "forwards": n_forwards,
            "cos_min": cos_min, "times": times, "requests": {"one": one, "batch32": batch32},
            "embeddings": got}


def run_f32_k6_serve_phase(hctx: dict, f32s: dict, rng: np.random.Generator, gpu: str) -> dict:
    """PCT_FFN_PALLAS=1 cli.serve --esm-dtype float32 --esm-weights <the HF
    directory> (load_esm takes the gate with float32), the f32 server's
    requests: K6-f32 and K1-f32 30 times each per backbone forward, no bf16
    K6, K1 or P1; the embeddings against the gate-off f32 server's at cosine
    >= F32_COSINE_MIN per row. /embed p50 and batch-32 seqs/s."""
    cfg = hctx["cfg"]
    mcfg = clip.CLIPConfig(input_dim=cfg.hidden_size, esm=cfg)
    argv = ["--checkpoint", str(WORK / "best_model.npz"), "--esm-dtype", "float32",
            "--batch-size", "32", "--index", str(WORK / "index.npz"), "--port", "0",
            "--esm-weights", str(hctx["dir"])]
    with ffn_gate(), counted_forwards() as forwards:
        reset_counts()
        sctx = start_server(argv)
        try:
            got = {key: embed_wire(sctx["base"], seqs, "rec")
                   for key, seqs in f32s["requests"].items()}
            n = len(forwards)
            launches = {"ffn_gelu_f32": ffn.launches["ffn_gelu_f32"],
                        "attention_fwd_f32": attention.launches["attention_fwd_f32"],
                        "ffn_gelu": ffn.launches["ffn_gelu"],
                        "attention_fwd": attention.launches["attention_fwd"],
                        "dense_mm": dense_mm.mm.launches}
            want = {"ffn_gelu_f32": cfg.num_layers * n, "attention_fwd_f32": cfg.num_layers * n,
                    "ffn_gelu": 0, "attention_fwd": 0, "dense_mm": 0}
            if not forwards or launches != want:
                raise AssertionError(f"gated f32 serve: launches {launches} over {n} forwards, "
                                     f"want {want}")
            cos = np.concatenate([row_cosines(got[key], f32s["embeddings"][key]) for key in got])
            diff = max(float(np.abs(got[key] - f32s["embeddings"][key]).max()) for key in got)
            cos_min = float(cos.min())
            log(f"[f32 K6 serve] PCT_FFN_PALLAS=1 --esm-dtype float32 from the HF directory: "
                f"/embed of 1 and of 32 sequences, {n} backbone forwards, ffn_gelu_f32 "
                f"{launches['ffn_gelu_f32']} and attention_fwd_f32 "
                f"{launches['attention_fwd_f32']} = {cfg.num_layers} each per forward, bf16 "
                f"ffn_gelu, attention_fwd and dense_mm 0; against the gate-off f32 server, "
                f"{len(cos)} rows: min cosine {cos_min:.9f}, 1 - min {1 - cos_min:.3g} (need <= "
                f"{1 - F32_COSINE_MIN:g}), max |difference| {diff:.6g}")
            if not 1 - cos_min <= 1 - F32_COSINE_MIN:
                raise AssertionError(f"gated f32 serving drifts from the gate off: cosine "
                                     f"{cos_min}")
            heads = checkpoint.load_npz(WORK / "best_model.npz", clip.abstract_params(mcfg))
            times = time_serving({**sctx, "heads": heads, "esm_params": hctx["esm_params"],
                                  "mcfg": mcfg, "batch32": f32s["requests"]["batch32"]}, rng,
                                 gpu, "f32 PCT_FFN_PALLAS=1")
        finally:
            stop(sctx)
    return {"launches": launches, "forwards": n, "cos_min": cos_min, "max_abs_diff": diff,
            "times": times}


def f32_frozen_step() -> dict:
    """One packed frozen train step at global batch 256 over an f32
    backbone (dropout 0.1), from the same heads and generator seed with
    PCT_FFN_PALLAS off and on: K1-f32 once a layer per chunk forward, no K5,
    no bf16 attention; K6-f32 as often as K1-f32 under the gate and never
    without; finite losses, the gated one within K6_F32_STEP_LOSS_TOL
    (relative) of the gate-off one."""
    mcfg, _, heads0, peps, recs = packed_setup()
    cfg_esm = common.esm_config("t30_150M", "float32")
    mcfg = dataclasses.replace(mcfg, esm=cfg_esm)
    esm_params = esm2.init_params(cfg_esm, torch.Generator(device="cuda").manual_seed(0),
                                  dtype=torch.float32, device="cuda")
    cfg = clip_engine.EngineConfig(model=mcfg, packed=True)
    batch = to_device(packed_engine.tokenize_packed(common.make_tokenizer(), peps, recs), "cuda")
    want = cfg_esm.num_layers * len(packed_chunks(batch))
    losses = {}
    for gated in (False, True):
        params = clone_tree(heads0)
        state = optimizer.adam(TRAIN_LR).init(params)
        reset_counts()
        with ffn_gate() if gated else contextlib.nullcontext():
            _, _, loss = clip_engine.make_train_step(cfg)(
                params, state, esm_params, batch, torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        got = (attention.launches["attention_fwd_f32"], attention.launches["attention_bwd_f32"],
               attention.launches["attention_fwd"], ffn.launches["ffn_gelu_f32"],
               ffn.launches["ffn_gelu"])
        what = "PCT_FFN_PALLAS=1" if gated else "gate off"
        log(f"[f32 train] one packed frozen step ({what}; 256 pairs, {len(packed_chunks(batch))} "
            f"chunk forwards): loss {float(loss):.9f}; attention_fwd_f32 {got[0]} (want {want}), "
            f"attention_bwd_f32 {got[1]}, bf16 attention_fwd {got[2]}, ffn_gelu_f32 {got[3]} "
            f"(want {want if gated else 0}), bf16 ffn_gelu {got[4]}")
        if got != (want, 0, 0, want if gated else 0, 0) or not math.isfinite(float(loss)):
            raise AssertionError(f"the packed frozen f32 step ({what}): launches {got}, loss "
                                 f"{float(loss)}")
        losses[gated] = float(loss)
    rel = abs(losses[True] - losses[False]) / abs(losses[False])
    log(f"[f32 train] the gated frozen f32 step's loss against the gate-off one: relative "
        f"{rel:.3g} (tolerance {K6_F32_STEP_LOSS_TOL:g})")
    if not rel <= K6_F32_STEP_LOSS_TOL:
        raise AssertionError(f"the gated frozen f32 step's loss is {rel} from the gate off")
    return {"loss": losses[False], "gated_loss": losses[True], "gated_loss_rel_err": rel,
            "attention_fwd_f32": want, "ffn_gelu_f32": want}


def check_f32_finetune_step(fault_libs: dict) -> dict:
    """The packed finetune step at global batch 256 over an f32 backbone
    (dropout 0) through K1-f32/K5-f32 against the same step through K1-f32
    and K5-f32's plain version, and through K5-f32's swept-tile fault build:
    every leaf within F32_FT_TOL of its largest entry, the loss within
    FT_LOSS_TOL relative; the fault past it. Then the same step under
    PCT_FFN_PALLAS=1 against it (check_f32_gated_step)."""
    out = finetune_step_runs(fault_libs, packed=True,
                             names=("kernel", "k1_plain_bwd", "fault", "gated", "gated_again",
                                    "gated_reordered"), dtype=torch.float32)
    smooth = finetune_step_runs(fault_libs, packed=True,
                                names=("kernel", "gated", "gated_fault", "gated_tf32"),
                                dtype=torch.float32, activation=F32_SMOOTH_HEADS)
    (lk, gk), (lp, gp), (_, gf) = out["kernel"], out["k1_plain_bwd"], out["fault"]
    tight = {k: v[0] for k, v in leaf_gaps(gk, gp).items()}
    fault = {k: v[0] for k, v in leaf_gaps(gf, gp).items()}
    worst, worst_fault = max(tight, key=tight.get), max(fault, key=fault.get)
    top3 = sorted(tight.items(), key=lambda kv: -kv[1])[:3]
    loss_rel = abs(lk - lp) / abs(lp)
    ok = tight[worst] <= F32_FT_TOL and loss_rel <= FT_LOSS_TOL
    log(f"[f32 train] packed finetune step at 256 in f32 (chunk forwards a pass "
        f"{out['shapes']}; dropout 0): loss through K1-f32/K5-f32 {lk:.9f}, through K5-f32's "
        f"plain version {lp:.9f}, relative {loss_rel:.3g} (tolerance {FT_LOSS_TOL:g}); largest "
        f"max|err|/leaf max {tight[worst]:.4g} ({worst}; next "
        + ", ".join(f"{k} {v:.4g}" for k, v in top3[1:])
        + f"; tolerance {F32_FT_TOL:g}); the planted fault (K5-f32 built to drop the last "
        f"query tile of dk/dv): {fault[worst_fault]:.4g} ({worst_fault}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K5-f32 in the f32 packed finetune step disagrees with its plain "
                             "version")
    if fault[worst_fault] <= F32_FT_TOL:
        raise AssertionError("the f32 finetune step check does not see a K5-f32 that drops a "
                             "query tile")
    return {"loss_rel_err": loss_rel, "grad_rel_err": tight[worst], "grad_leaf": worst,
            "fault_rel_err": fault[worst_fault], "fault_leaf": worst_fault,
            "tolerance": F32_FT_TOL, "k6_gate": check_f32_gated_step(out, smooth)}


def worst_leaf(a: dict, b: dict) -> tuple[str, float]:
    """The leaf of the largest max|a - b| / max|b| and that ratio."""
    gaps = {k: v[0] for k, v in leaf_gaps(a, b).items()}
    leaf = max(gaps, key=gaps.get)
    return leaf, gaps[leaf]


def check_f32_gated_step(out: dict, smooth: dict) -> dict:
    """The f32 packed finetune step under PCT_FFN_PALLAS=1 (K6-f32 in the
    forward, plain_composition's f32 GEMMs in the backward) against the
    same step with the gate off, both through K1-f32/K5-f32. With the
    default ReLU heads (``out``): the loss within FT_LOSS_TOL relative, run
    twice equal to the bit, and every leaf's gap printed beside the gap of
    the same step with the wi product in exact f32 summed in another order
    (gated_reordered), which ReLU flips set (F32_SMOOTH_HEADS). With
    F32_SMOOTH_HEADS (``smooth``): every leaf within F32_FT_TOL of its
    largest entry, the loss within FT_LOSS_TOL; K6-f32's planted faults
    (FFN_F32_FAULTS) each past F32_FT_TOL in a leaf."""
    (lk, gk), (lg, gg), (lga, gga), (lr, gr) = (out[k] for k in (
        "kernel", "gated", "gated_again", "gated_reordered"))
    relu_leaf, relu_gap = worst_leaf(gg, gk)
    floor_leaf, floor_gap = worst_leaf(gr, gk)
    loss_rel = abs(lg - lk) / abs(lk)
    same = lg == lga and all(torch.equal(gg[k], gga[k]) for k in gg)
    (sk, gsk), (sg, gsg) = smooth["kernel"], smooth["gated"]
    smooth_leaf, smooth_gap = worst_leaf(gsg, gsk)
    smooth_loss = abs(sg - sk) / abs(sk)
    ok = loss_rel <= FT_LOSS_TOL and smooth_loss <= FT_LOSS_TOL and smooth_gap <= F32_FT_TOL
    faults = {}
    for run, name in (("gated_fault", "ffn_f32_k_tile"), ("gated_tf32", "ffn_f32_tf32")):
        lf, gf = smooth[run]
        leaf, gap = worst_leaf(gf, gsk)
        faults[name] = {"loss_rel_err": abs(lf - sk) / abs(sk), "grad_rel_err": gap,
                        "grad_leaf": leaf}
    log(f"[f32 train] packed finetune step at 256 in f32 under PCT_FFN_PALLAS=1 (K6-f32) "
        f"against the gate off, ReLU heads: loss {lg:.9f} vs {lk:.9f}, relative "
        f"{loss_rel:.3g} (tolerance {FT_LOSS_TOL:g}); largest max|err|/leaf max {relu_gap:.4g} "
        f"({relu_leaf}), with the wi product in exact f32 in another order "
        f"{floor_gap:.4g} ({floor_leaf}; loss {abs(lr - lk) / abs(lk):.3g}); run twice: "
        f"{'equal' if same else 'DIFFERENT'} to the bit. {F32_SMOOTH_HEADS} heads: loss "
        f"{smooth_loss:.3g}, largest max|err|/leaf max {smooth_gap:.4g} ({smooth_leaf}; "
        f"tolerance {F32_FT_TOL:g}); the planted faults: "
        + "; ".join(f"{name} ({FFN_F32_FAULTS[name]}) loss {f['loss_rel_err']:.3g}, "
                    f"{f['grad_rel_err']:.4g} ({f['grad_leaf']})" for name, f in faults.items())
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the gated f32 finetune step disagrees with the gate off")
    for name, f in faults.items():
        if f["grad_rel_err"] <= F32_FT_TOL:
            raise AssertionError(f"the gated f32 step check does not see K6-f32's fault {name}")
    if not same:
        raise AssertionError("the gated f32 finetune step is not repeatable to the bit")
    return {"loss_rel_err": loss_rel, "relu_grad_rel_err": relu_gap, "relu_grad_leaf": relu_leaf,
            "reordered_f32_grad_rel_err": floor_gap, "reordered_f32_grad_leaf": floor_leaf,
            "smooth_heads": F32_SMOOTH_HEADS, "smooth_loss_rel_err": smooth_loss,
            "grad_rel_err": smooth_gap, "grad_leaf": smooth_leaf, "faults": faults,
            "deterministic": same, "tolerance": F32_FT_TOL}


def run_f32_train_phase(fault_libs: dict) -> dict:
    """cli.main --packed --finetune --esm-dtype float32 for one epoch on the
    1100-family fixture (run_packed_unfrozen's checks with K1-f32 and
    K5-f32), with the gate off and under PCT_FFN_PALLAS=1 (K6-f32 as often
    as K1-f32), one packed frozen f32 step with the gate off and on, and the
    f32 finetune step check (the gated step's included)."""
    data_dir = WORK / SMALL_DATA
    out = {}
    for name, gated in (("finetune_packed", False), ("finetune_packed_k6", True)):
        with ffn_gate() if gated else contextlib.nullcontext():
            out[name] = run_packed_unfrozen(
                f"train_{name}_f32", data_dir, ["--finetune"], finetune,
                families=SMALL_FIXTURE_FAMILIES, dtype=torch.float32, gated=gated)
        out[name]["profile"] = f"{SMALL_FIXTURE_FAMILIES} families"
    out["frozen_step"] = f32_frozen_step()
    out["step_check"] = check_f32_finetune_step(fault_libs)
    return out


def f32_attention_bound(seg: torch.Tensor, backward: bool, nh: int, dh: int) -> dict:
    """K1-f32's (or K5-f32's) bound on this run's segments: attention_work's
    counts as attention_bound takes them, with f32 operands (4 bytes) and
    each product kept at f32 accuracy as three TF32 products on the tensor
    cores (at H100_TF32_FLOPS, as infonce_bound and maxsim_bound take K2, K3
    and K4); beside it the ceiling of the FFMA design the kernels replaced
    (tools/probe_attention_f32_ffma.cu), the same products at the f32 rate
    of the CUDA cores (H100_F32_FLOPS)."""
    B, T = seg.shape
    w = attention_work(seg)
    row = nh * dh * 4
    if backward:
        flops = nh * 5 * 2 * dh * w["pairs"] + nh * dh * (w["pads"] + w["padded_rows_tokens"])
        nbytes = row * (3 * w["valid"] + 4 * B * T) + B * T * 4
    else:
        flops = nh * 2 * 2 * dh * w["pairs"] + nh * dh * w["padded_rows_tokens"]
        nbytes = row * (2 * w["valid"] + 2 * B * T) + B * T * 4
    t_ops, t_bytes = 3 * flops / H100_TF32_FLOPS, nbytes / H100_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "ffma_ceiling_ms": 1e3 * max(flops / H100_F32_FLOPS, t_bytes),
            "allowed_share": w["pairs"] / (B * T * T),
            "counts": f"{3 * flops / 1e9:.4f} GFLOP TF32 (3 x {flops / 1e9:.4f} GFLOP f32), "
                      f"{nbytes / 1e6:.4f} MB"}


def time_attention_f32(gen: torch.Generator, gpu: str) -> list[dict]:
    """K1-f32 and K5-f32 at t30_150M's (16, 512, 20, 32) padded and dense,
    and at each other family's attention shape (FAMILY_SHAPES) padded, with
    TF32 off: K1-f32, its plain version and scaled_dot_product_attention on
    f32 with the same boolean mask; K5-f32 fed K1-f32's output and
    statistics, its plain version and SDPA's backward; in device time by
    kernel_times, each beside its bound on the run's segments."""
    rows = []
    shapes = ([(padded_segments(16, 512), NH, DH, "padded"),
               (dense_segments(16, 512), NH, DH, "dense")]
              + [(padded_segments(B, T), nh, dh, "padded") for B, T, nh, dh in FAMILY_SHAPES])
    for seg, nh, dh, kind in shapes:
        B, T = seg.shape
        allowed = ((seg[:, None, :, None] == seg[:, None, None, :])
                   & (seg[:, None, None, :] > 0))
        sets = []
        for _ in range(2):      # 2 x 84 MB: successive calls miss the 50 MB L2
            q, k, v = qkv(B, T, gen, nh, dh, torch.float32)
            do = torch.randn(B, T, nh, dh, device="cuda", generator=gen)
            out, lse = attention._forward(q, k, v, seg, with_lse=True)
            lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            sdpa_out = torch.nn.functional.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=allowed, scale=1.0)
            sets.append((q, k, v, do, lse, out, (sdpa_out, (lq, lk, lv), do.transpose(1, 2))))
        cycle = itertools.cycle(sets)

        def sdpa():
            q, k, v = (x.transpose(1, 2) for x in next(cycle)[:3])
            torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=allowed,
                                                             scale=1.0)

        def k5():
            q, k, v, do, lse, out, _ = next(cycle)
            attention.fused_attention_bwd(q, k, v, seg, do, lse, out)

        def k5_plain():
            q, k, v, do = next(cycle)[:4]
            by_rows(attention.attention_reference_bwd, q, k, v, seg, do)

        def sdpa_bwd():
            o, inputs, do = next(cycle)[6]
            torch.autograd.grad(o, inputs, do, retain_graph=True)

        k1_t = kernel_times(lambda: attention.fused_attention(*next(cycle)[:3], seg), 50)
        fwd = {"ms": k1_t["device_ms"], "records": k1_t["records"],
               "events_ms": k1_t["events_ms"],
               "plain_ms": kernel_times(lambda: by_rows(attention.attention_reference,
                                                        *next(cycle)[:3], seg), 5)["device_ms"],
               "library_ms": kernel_times(sdpa, 20)["device_ms"],
               **f32_attention_bound(seg, False, nh, dh)}
        k5_t = kernel_times(k5, 50)
        bwd = {"ms": k5_t["device_ms"], "records": k5_t["records"],
               "events_ms": k5_t["events_ms"],
               "plain_ms": kernel_times(k5_plain, 5)["device_ms"],
               "library_ms": kernel_times(sdpa_bwd, 20)["device_ms"],
               **f32_attention_bound(seg, True, nh, dh)}
        for name, row in (("attention_fwd_f32", fwd), ("attention_bwd_f32", bwd)):
            counts = row.pop("counts")
            log(f"[time] {name} B={B} T={T} NH={nh} DH={dh} {kind}: kernel {row['ms']:.6f} ms "
                f"({row['records']:g} kernel records kept a call; CUDA events "
                f"{row['events_ms']:.6f} ms), plain {row['plain_ms']:.6f} ms, library "
                f"(scaled_dot_product_attention{' backward' if 'bwd' in name else ''}, f32, "
                f"TF32 off) {row['library_ms']:.6f} ms, bound {row['bound_ms']:.6f} ms "
                f"({row['bound_by']}: {counts}; allowed pairs {row['allowed_share']:.4f} of "
                f"T^2; TF32 peak {H100_TF32_FLOPS / 1e12:g} TFLOP/s) = "
                f"{100 * row['bound_ms'] / row['ms']:.2f}% of the bound; the replaced FFMA "
                f"design's ceiling (f32 {H100_F32_FLOPS / 1e12:g} TFLOP/s on the CUDA cores) "
                f"{row['ffma_ceiling_ms']:.6f} ms | {gpu}")
        rows.append({"shape": [B, T, nh, dh], "segments": kind, "attention_fwd_f32": fwd,
                     "attention_bwd_f32": bwd})
    return rows


# ---------------------------------------------------------------------------
# Phase 7c: ESM-2 t33_650M (head dim 64) at full width and depth, and the
# other families through the model
# ---------------------------------------------------------------------------

def run_t33_serve_phase(rng: np.random.Generator, gpu: str) -> dict:
    """cli.serve --esm-config t33_650M over seeded random weights and CLIP
    heads written as npz: an index of 64 sequences by cli.embed, /healthz,
    single-sequence /embed at buckets 64 and 512 on both sides and a
    32-sequence /embed; K1 33 times per backbone forward; the embeddings
    against eager attention (cosine >= COSINE_MIN per row); /embed p50 and
    batch-32 seqs/s. The server stops at the end of the phase."""
    cfg = common.esm_config(T33, "bfloat16")
    mcfg = clip.CLIPConfig(input_dim=cfg.hidden_size, esm=cfg)
    work = WORK / T33
    work.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    esm_params = esm2.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                                  dtype=torch.bfloat16, device="cuda")
    heads = clip.init_params(mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    export_npz(work / "esm.npz", esm_params)
    export_npz(work / "best_model.npz", heads)
    fasta = work / "corpus.fasta"
    fasta.write_text("".join(f">seq{i}\n{s}\n" for i, s in
                             enumerate(synthetic_seqs(rng, rng.integers(30, 500, 64)))))
    log(f"[t33] {T33} bf16 random weights (seed {SEED}) and heads written in "
        f"{time.perf_counter() - t0:.1f} s")
    model_args = ["--esm-config", T33, "--checkpoint", str(work / "best_model.npz"),
                  "--esm-weights", str(work / "esm.npz"), "--batch-size", "32"]
    with counted_forwards() as forwards:
        reset_counts()
        embed.main(model_args + ["--fasta", str(fasta), "--side", "rec",
                                 "--out", str(work / "index.npz")])
        server = serve.make_server(serve.build_argparser().parse_args(
            model_args + ["--index", str(work / "index.npz"), "--port", "0"]))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        ctx = {"base": base, "server": server, "thread": thread, "mcfg": mcfg,
               "esm_params": esm_params, "heads": heads}
        try:
            health = json.loads(call(base, "/healthz")[1])
            if not (health["status"] == "ok" and health["index_size"] == 64
                    and health["model"] == T33):
                raise AssertionError(f"{T33} /healthz {health}")
            singles = {}
            for bucket, n in ((64, 40), (512, 400)):
                seq = synthetic_seqs(rng, [n])[0]
                for side in ("pep", "rec"):
                    singles[(side, bucket)] = (seq, embed_json(base, [seq], side)[0])
            batch32 = synthetic_seqs(rng, rng.integers(50, 300, 32))
            ctx.update(singles=singles, batch32=batch32, emb32=embed_json(base, batch32, "rec"))
            launches = attention.launches["attention_fwd"]
            check_default_path(f"{T33} serve")
            if not forwards or launches != cfg.num_layers * len(forwards):
                raise AssertionError(f"{T33} serve: attention_fwd launched {launches} times for "
                                     f"{len(forwards)} forwards; want {cfg.num_layers} each")
            log(f"[t33] /healthz {health}; /embed of 4 single sequences and of 32: "
                f"{len(forwards)} backbone forwards, attention_fwd {launches} = "
                f"{cfg.num_layers} per forward")
            ctx["cos_min"] = check_end_to_end(ctx)
            ctx["times"] = time_serving(ctx, rng, gpu, f"{T33} bf16")
        finally:
            stop(ctx)
    ctx["launches"] = {"attention_fwd": launches}
    return ctx


def run_families_phase() -> dict:
    """esm2.forward in bf16 through K1 for the other families (FAMILY_RUNS:
    t6_8M and t12_35M at full depth, t36_3B and t48_15B at full width and 2
    layers) with seeded random weights, on padded rows (8 sequences of
    30-500 aa) and on the same sequences packed (derive_segments' segments
    and positions): K1 once a layer per forward, and the valid tokens'
    hidden states against attention_impl="eager" at cosine >= COSINE_MIN."""
    rng = np.random.default_rng(SEED)
    tok = common.make_tokenizer()
    seqs = synthetic_seqs(rng, rng.integers(30, 500, 8))
    ids = torch.from_numpy(tok(seqs)["input_ids"]).cuda()
    packed = packed_engine.tokenize_packed(tok, seqs, seqs)
    pids, pseg, ppos = packed_engine.derive_segments(packed["rec_ids"].cuda())
    batches = {"padded": (ids, (ids != 1).to(torch.int32), {}),
               "packed": (pids, (pseg > 0).to(torch.int32),
                          {"segment_ids": pseg, "positions": ppos})}
    out = {}
    for family, layers in FAMILY_RUNS:
        cfg = common.esm_config(family, "bfloat16")
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        params = esm2.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                                  dtype=torch.bfloat16, device="cuda")
        eager = dataclasses.replace(cfg, attention_impl="eager")
        row = {"head_dim": cfg.head_dim, "layers": cfg.num_layers}
        for kind, (x, mask, kw) in batches.items():
            reset_counts()
            with torch.inference_mode():
                got = esm2.forward(params, x, mask, cfg, **kw)
                k1 = attention.launches["attention_fwd"]
                want = esm2.forward(params, x, mask, eager, **kw)
            valid = mask > 0
            cos = float(torch.nn.functional.cosine_similarity(
                got[valid].float(), want[valid].float(), dim=-1).min())
            ok = k1 == cfg.num_layers and cos >= COSINE_MIN and bool(torch.isfinite(got).all())
            log(f"[families] {family} (DH {cfg.head_dim}, {cfg.num_layers} layers) {kind} "
                f"{tuple(x.shape)}: attention_fwd {k1} launches, min cosine against eager "
                f"{cos:.6f} (need >= {COSINE_MIN}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{family} {kind} forward through K1")
            row[kind] = {"shape": list(x.shape), "launches": k1, "cos_min": cos}
        out[family] = row
        del params, got, want
    return out


def check_packed_embeddings_vs_plain(family: str, n: int = 256) -> float:
    """The first n training pairs' pooled embeddings through embed_packed
    (K1 on packed segments) against the same through K1's plain version:
    cosine >= COSINE_MIN per row on both sides."""
    mcfg, esm_params, heads0, peps, recs = packed_setup(n, family)
    packed = to_device(packed_engine.tokenize_packed(common.make_tokenizer(), peps, recs), "cuda")
    got = packed_engine.embed_packed(heads0, esm_params, packed, mcfg)
    with attention_function(plain_forward, plain_backward):
        want = packed_engine.embed_packed(heads0, esm_params, packed, mcfg)
    cos = min(float(row_cosines(g.cpu().numpy(), w.cpu().numpy()).min())
              for g, w in zip(got, want))
    log(f"[t33] {family} packed embeddings of {n} pairs through K1 against K1's plain version: "
        f"min cosine {cos:.6f} (need >= {COSINE_MIN})")
    if cos < COSINE_MIN:
        raise AssertionError(f"{family} packed embeddings through K1 drift from the plain form")
    return cos


def check_t33_finetune_step(fault_libs: dict) -> dict:
    """The packed finetune step of t33_650M at global batch T33_CHECK_BATCH
    through K1/K5 against the same step through K1 and K5's plain version
    (check_finetune_step's first check: every leaf within FT_K5_TOL of its
    largest entry, the loss within FT_LOSS_TOL), the swept-tile fault past
    it, and the step run twice equal to the bit."""
    out = finetune_step_runs(fault_libs, packed=True, family=T33, pool=T33_CHECK_BATCH,
                             names=("kernel", "again", "k1_plain_bwd", "fault"))
    (lk, gk), (lp, gp) = out["kernel"], out["k1_plain_bwd"]
    tight = {k: v[0] / FT_K5_TOL for k, v in leaf_gaps(gk, gp).items()}
    fault = {k: v[0] / FT_K5_TOL for k, v in leaf_gaps(out["fault"][1], gp).items()}
    worst, worst_fault = max(tight, key=tight.get), max(fault, key=fault.get)
    loss_rel = abs(lk - lp) / abs(lp)
    same = out["again"][0] == lk and all(torch.equal(out["again"][1][k], gk[k]) for k in gk)
    ok = tight[worst] <= 1.0 and loss_rel <= FT_LOSS_TOL
    log(f"[step] {T33} packed finetune step at global batch {T33_CHECK_BATCH} (chunk forwards a "
        f"pass {out['shapes']}; dropout 0): K5 against its plain version in the step: loss "
        f"relative {loss_rel:.3g} (tolerance {FT_LOSS_TOL:g}), largest max|err|/leaf max over "
        f"the tolerance {FT_K5_TOL:g}: {tight[worst]:.4g} ({worst}); the planted fault (K5 "
        f"built to drop the last query tile of dk/dv): {fault[worst_fault]:.4g} ({worst_fault}) "
        f"{'ok' if ok else 'FAIL'}; run twice: loss and gradients "
        f"{'equal' if same else 'DIFFER'} to the bit")
    if not ok:
        raise AssertionError(f"K5 in the {T33} packed finetune step disagrees with its plain "
                             "version")
    if fault[worst_fault] <= 1.0:
        raise AssertionError(f"the {T33} step check does not see a K5 that drops a query tile")
    if not same:
        raise AssertionError(f"the {T33} packed finetune step is not deterministic")
    return {"loss_rel_err": loss_rel, "grad_ratio": tight[worst], "grad_leaf": worst,
            "fault_ratio": fault[worst_fault], "fault_leaf": worst_fault}


def run_t33_train_phase(fault_libs: dict) -> dict:
    """t33_650M training at full width and depth on the smaller fixture:
    cli.main --esm-config t33_650M --packed and --packed --finetune for one
    epoch each (launch counts against the loaders' chunks, 33 K1 a chunk
    forward, 99 K1 and 33 K5 a pass-2 chunk), cli.embed with each
    checkpoint; the packed embeddings against K1's plain version; the
    packed step through K2 against the plain loss (check_step) and the
    packed finetune step through K5 against its plain version
    (check_t33_finetune_step), both at global batch T33_CHECK_BATCH; one
    packed finetune step at 256 under torch.profiler (launches, busy share,
    peak memory)."""
    data_dir = WORK / SMALL_DATA
    recs = sequences_only(WORK / "train_data" / "receptor.fasta")
    out = {"packed": run_packed_train(data_dir, T33, SMALL_FIXTURE_FAMILIES, "t33_train_packed")}
    embed_check(out["packed"]["run"] / "best_model.npz", recs,
                f"the {T33} packed run's best_model.npz", T33)
    out["finetune_packed"] = run_packed_unfrozen("t33_train_finetune_packed", data_dir,
                                                 ["--finetune"], finetune, T33,
                                                 SMALL_FIXTURE_FAMILIES)
    embed_check(out["finetune_packed"]["run"] / "best_model.npz", recs,
                f"the {T33} packed finetune run's best_model.npz", T33)
    for run in ("packed", "finetune_packed"):
        out[run].update(family=T33, profile=f"{SMALL_FIXTURE_FAMILIES} families")
    out["embeddings_cos_min"] = timed(f"{T33} check_packed_embeddings_vs_plain",
                                      check_packed_embeddings_vs_plain, T33)
    out["step_check"] = timed(f"{T33} check_step", check_step, T33_CHECK_BATCH, packed=True,
                              family=T33)
    out["finetune_step_check"] = timed("check_t33_finetune_step", check_t33_finetune_step,
                                       fault_libs)
    out["per_step"] = timed(f"{T33} launches_per_step", launches_per_step, True, finetune, T33)
    return out


# ---------------------------------------------------------------------------
# Phase 9: times
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Width tiers and MLM (phase 7d)
# ---------------------------------------------------------------------------

# The width-tier runs' corpus: bench.py's long-tail receptor lengths, where
# the width program splits a batch (it keeps one width on the synthetic
# fixture's 60-180 residues, as the TPU package's does on most mixes)
LONGTAIL_DATA = "longtail_data"
LONGTAIL_PAIRS = 1400
PACK_TIERS = 4
# The tiered step against the flat step over the same pairs, both through
# K2 from the same heads (dropout 0): the loss within TIER_STEP_TOL
# relative, in f32 (K1-f32 on both layouts), where the two differ only by
# f32 sums in another order; the bf16 gap (bf16 rounding of the backbone,
# which the row layout moves) is printed beside it.
TIER_STEP_TOL = 1e-5
MLM_BATCH = 64
# The MLM head step through K1 against the same step through K1's plain
# version (same weights, batch and masks): bf16 attention outputs that
# differ by P's rounding, through 30 layers, move the mean masked
# cross-entropy by this much at most (relative).
MLM_LOSS_RTOL = 2 ** -10
# The MLM finetune step through K1/K5 against K5's plain version, per leaf
# as FT_K5_TOL holds CLIP's: the token embedding table, whose gradient
# through the backbone nearly cancels beside the tied decoder's, reads
# 1.36 x 2^-6 of its largest entry on an H100 (its other leaves under
# 2^-6), as FILIP's finetune step reads 1.26-1.64 x 2^-6 there (ROADMAP
# queue 3); the limit is FILIP_FT_K5_TOL's 2^-4, which K5 built to drop its
# last query tile passes by 6 times (0.3768).
MLM_FT_K5_TOL = FILIP_FT_K5_TOL
MLM_RUNS = (("mlm_head", []), ("mlm_head_packed", ["--packed"]),
            ("mlm_finetune_packed", ["--packed", "--finetune"]))


def write_longtail_fixture(data_dir: Path) -> None:
    """LONGTAIL_PAIRS pairs from numpy.random.default_rng(42): peptides of
    8-29 residues and receptors of bench.py's long-tail profile (90% of
    100-399 residues, 10% of 1200-1998; bench_train.rec_len), written as
    peptide/receptor (cli.main) and protein1/protein2
    (cli.main_2protein_filip). The sequences are random: each its own
    cluster."""
    if (data_dir / "receptor.fasta").exists():
        return
    rng = np.random.default_rng(42)
    aas = list(AAS)
    peps = ["".join(rng.choice(aas, rng.integers(8, 30))) for _ in range(LONGTAIL_PAIRS)]
    recs = ["".join(rng.choice(aas, bench_train.rec_len(rng, "longtail")))
            for _ in range(LONGTAIL_PAIRS)]
    data_dir.mkdir(parents=True, exist_ok=True)
    for names in (("peptide", "receptor"), ("protein1", "protein2")):
        for name, seqs in zip(names, (peps, recs)):
            write_fasta(data_dir / f"{name}.fasta", [(f"{name}_{i}", q) for i, q in
                                                      enumerate(seqs)])


def tier_layout(batch: dict) -> dict:
    """(rows, width) of each pack of each side of a packed host batch."""
    return {side: [tuple(pk["ids"].shape) for pk in wire_packs(batch, side)]
            for side in ("pep", "rec")}


def tiered_step(batch: dict, esm_params: dict, dtype_name: str, tiers: int,
                loss_fn=None) -> tuple:
    """One packed frozen step at global batch 256 from the CLIP heads of
    seed SEED (dropout 0, Adam lr TRAIN_LR): (loss, gradients, K1 or K1-f32
    launches)."""
    cfg_esm = common.esm_config("t30_150M", dtype_name)
    mcfg = clip.CLIPConfig(input_dim=cfg_esm.hidden_size, dropout=0.0, esm=cfg_esm)
    cfg = clip_engine.EngineConfig(model=mcfg, packed=True, packed_tiers=tiers)
    params = clip.init_params(mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    state = capturing(optimizer.adam(TRAIN_LR).init(params), params)
    name = attention._kernel("attention_fwd", cfg_esm.compute_dtype)
    before = attention.launches[name]
    _, _, loss = clip_engine.make_train_step(cfg, loss_fn)(params, state, esm_params,
                                                            to_device(batch, "cuda"), None)
    torch.cuda.synchronize()
    return float(loss), state.grads, attention.launches[name] - before


def check_tiered_step(tiered: dict, flat: dict) -> dict:
    """The run's first batch in width tiers: one step through K2 against the
    same step through the plain loss (the loss within 1e-5 relative, every
    gradient within 1e-5 of the step's largest entry; per leaf, as
    check_step holds the flat packed step, printed); then against the same
    pairs flat-packed, through K2, in f32 (the loss within TIER_STEP_TOL)
    and in bf16 (printed). K1 30 times per chunk forward of each layout."""
    out = {}
    for dtype_name in ("bfloat16", "float32"):
        cfg_esm = common.esm_config("t30_150M", dtype_name)
        esm_params = esm2.init_params(cfg_esm, torch.Generator(device="cuda").manual_seed(0),
                                      dtype=cfg_esm.compute_dtype, device="cuda")
        runs = {"tiered": tiered_step(tiered, esm_params, dtype_name, PACK_TIERS),
                "flat": tiered_step(flat, esm_params, dtype_name, 1)}
        if dtype_name == "bfloat16":
            runs["plain"] = tiered_step(tiered, esm_params, dtype_name, PACK_TIERS,
                                        infonce.clip_infonce)
        for name, b in (("tiered", tiered), ("flat", flat)):
            if runs[name][2] != 30 * len(packed_chunks(b)):
                raise AssertionError(f"tiered step check ({dtype_name}, {name}): attention "
                                     f"launches {runs[name][2]}, want 30 x "
                                     f"{len(packed_chunks(b))} chunk forwards")
        (lt, gt, _), (lf, gf, _) = runs["tiered"], runs["flat"]
        out[dtype_name] = {"loss": lt, "flat_loss": lf, "flat_loss_rel_err": abs(lt - lf) / abs(lf),
                           "flat_grad_rel_err": max(float((gt[k] - gf[k]).abs().max())
                                                    / float(gf[k].abs().max()) for k in gf)}
        if "plain" in runs:
            lp, gp, _ = runs["plain"]
            scale = max(float(g.abs().max()) for g in gp.values())
            leaf = {k: float((gt[k] - gp[k]).abs().max()) / float(gp[k].abs().max()) for k in gp}
            out[dtype_name].update(
                plain_loss_rel_err=abs(lt - lp) / abs(lp),
                plain_grad_rel_err=max(float((gt[k] - gp[k]).abs().max()) for k in gp) / scale,
                plain_leaf_rel_err=max(leaf.values()), plain_worst_leaf=max(leaf, key=leaf.get))
        del esm_params
        gc.collect()
    b16, f32 = out["bfloat16"], out["float32"]
    ok = (f32["flat_loss_rel_err"] <= TIER_STEP_TOL and b16["plain_loss_rel_err"] <= 1e-5
          and b16["plain_grad_rel_err"] <= 1e-5)
    log(f"[tiers] one step at 256 on the run's first batch: in width tiers through K2 vs the "
        f"plain loss: loss relative |err| {b16['plain_loss_rel_err']:.3g}, gradients "
        f"{b16['plain_grad_rel_err']:.3g} of the step's largest entry (tolerance 1e-5; of each "
        f"leaf's own largest {b16['plain_leaf_rel_err']:.3g} at {b16['plain_worst_leaf']}); in "
        f"tiers vs flat-packed, f32 "
        f"(K1-f32): loss {f32['loss']:.7f} vs {f32['flat_loss']:.7f}, relative |err| "
        f"{f32['flat_loss_rel_err']:.3g} (tolerance {TIER_STEP_TOL:g}), gradients "
        f"{f32['flat_grad_rel_err']:.3g}; bf16: loss {b16['loss']:.7f} vs {b16['flat_loss']:.7f}, "
        f"relative |err| {b16['flat_loss_rel_err']:.3g}, gradients "
        f"{b16['flat_grad_rel_err']:.3g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the tiered step disagrees with the plain loss or the flat step")
    return out


def tier_chunk_segments(steps: list, evals: list) -> list[tuple[str, torch.Tensor]]:
    """The segment ids of the first and the last chunk of each pack of each
    side of the run's first batch (a pack's last chunk holds its ratchet
    rows, all <pad>), and the last chunk of a placeholder pack (every row
    <pad>) from the epoch's batches, or one of its shape made here if no
    batch left a width empty."""
    out = []
    for side in ("pep", "rec"):
        packs = wire_packs(steps[0], side)
        l_max = max(pk["ids"].shape[1] for pk in packs)
        for pk in packs:
            R, L = pk["ids"].shape
            rows = chunk_rows(R, 16 * (l_max // L))
            seg = packed_engine.derive_segments(pk["ids"].cuda())[1]
            for where, chunk in (("first", seg[:rows]), ("last", seg[-rows:])):
                pads = int((chunk.amax(1) == 0).sum())
                out.append((f"packed, width tier {L} {side} {where} chunk ({R} rows), {pads} "
                            "rows all <pad>", chunk.contiguous()))
    holes = [(b, side, pk) for b in steps + evals for side in ("pep", "rec")
             for pk in b.get(f"{side}_packs", ()) if pk["nmark"].shape[0] == 0]
    if holes:
        b, side, pk = holes[0]
        l_max = max(p["ids"].shape[1] for p in b[f"{side}_packs"])
        R, L = pk["ids"].shape
        seg = packed_engine.derive_segments(pk["ids"].cuda())[1][-chunk_rows(R, 16 * (l_max // L)):]
        what = f"a placeholder pack's chunk ({side}, {len(holes)} placeholder packs in the epoch)"
    else:
        seg = torch.zeros(16, 512, dtype=torch.int32, device="cuda")
        what = "a placeholder pack's chunk (made here: no batch left a width empty)"
    out.append((f"packed, {what}, every row <pad>", seg.contiguous()))
    return out


def check_tier_chunks(segments: list, fault_libs: dict, gen: torch.Generator) -> dict:
    """K1 (with its statistics) against its plain version on the tier
    chunks (check_attention's form: rms(ref) of the valid queries), then
    both attention faults, each of which must fail a case with a real row."""
    cases = [(*seg.shape, kind, True, *qkv(*seg.shape, gen), seg) for kind, seg in segments]
    err = check_attention(cases)
    fwd = attention._kernel("attention_fwd", torch.bfloat16)
    faults = {}
    for name in ("swept_tiles", "skip"):
        with attention_kernels(fault_libs[name], (fwd,)):
            rows = k1_readings(cases)
        ratios = [max(r["need"] / r["atol"], r["lse_err"] / LSE_ATOL) for r in rows]
        failed = sum(x > 1 for x in ratios)
        faults[name] = {"cases_failed": failed, "cases": len(rows), "worst_ratio": max(ratios)}
        log(f"[tiers] planted fault {name}: attention_fwd fails {failed} of {len(rows)} tier "
            f"chunks, worst at {max(ratios):.4g} x its tolerance")
        if not failed:
            raise AssertionError(f"the tier chunks' K1 check does not see the fault {name}")
    return {"max_abs_err": err, "shapes": [list(seg.shape) for _, seg in segments],
            "fault": faults}


def run_tiers_phase(fault_libs: dict, gen: torch.Generator) -> dict:
    """cli.main --packed --pack-tiers 4 for one epoch on the long-tail
    fixture (launches against its batches packed again here), the layout of
    its first batch against the flat wire, the step check and K1 on its
    chunks; then cli.main_2protein_filip --packed --pack-tiers 4 at batch
    128 (K4 once per (pep pack, rec pack) block), K4 on its blocks and its
    step against the plain max-sim."""
    data_dir = WORK / LONGTAIL_DATA
    write_longtail_fixture(data_dir)
    run = run_packed_train(data_dir, name="train_tiered", tiers=PACK_TIERS)
    steps, evals = packed_epoch_batches(data_dir, PACK_TIERS)
    flat_steps, _ = packed_epoch_batches(data_dir, 1)
    layout, flat = tier_layout(steps[0]), tier_layout(flat_steps[0])
    if len(layout["rec"]) < 2:
        raise AssertionError(f"the long-tail fixture's first batch took one width: {layout}")
    slots = {k: {side: sum(r * w for r, w in v[side]) for side in v}
             for k, v in (("tiered", layout), ("flat", flat))}
    holes = sum(pk["nmark"].shape[0] == 0 for b in steps + evals for side in ("pep", "rec")
                for pk in b.get(f"{side}_packs", ()))
    log(f"[tiers] first batch (rows, width) a pack: tiered {layout}, flat {flat}; slots tiered "
        f"{slots['tiered']}, flat {slots['flat']}; chunk forwards tiered "
        f"{len(packed_chunks(steps[0]))}, flat {len(packed_chunks(flat_steps[0]))}; "
        f"{holes} placeholder packs over the epoch's {len(steps) + len(evals)} batches")
    segments = tier_chunk_segments(steps, evals)
    out = {"run": run, "layout": layout, "flat_layout": flat, "slots": slots,
           "placeholder_packs": holes, "segments": segments,
           "step_check": timed("check_tiered_step", check_tiered_step, steps[0], flat_steps[0]),
           "chunks": check_tier_chunks(segments, fault_libs, gen)}
    out["filip"] = run_filip_tiered(data_dir, fault_libs, gen)
    return out


def filip_captured_blocks(run: dict, data_dir: Path) -> list[tuple]:
    """The K4 blocks the packed FILIP similarity scores on a run's first
    batch (the run's best heads, eval mode), as the path forms them: each
    (pep pack or tier, rec pack or tier) pair, phantom rows included."""
    mcfg, esm_params = filip_setup()
    heads = checkpoint.load_npz(run["run"] / "best_model.npz",
                                filip.init_params(mcfg, torch.Generator(), device="meta"), "cuda")
    _, batch = filip_first_batch(data_dir, run["args"])
    blocks = []

    def capture(ha, hb, ma, mb, t):
        blocks.append((ha, hb, ma, mb))
        return maxsim.filip_similarity_fused(ha, hb, ma, mb, t)

    with torch.no_grad():
        filip_packed.filip_sim_packed(heads, esm_params, batch, mcfg,
                                      packed_engine.packed_side_count(batch, "pep"),
                                      similarity_fn=capture)
    return [blk for blk in blocks if len(blk[0]) and len(blk[1])]


def run_filip_tiered(data_dir: Path, fault_libs: dict, gen: torch.Generator) -> dict:
    run = run_filip_more("filip_tiered_128", data_dir, ["--packed", "--pack-tiers",
                                                        str(PACK_TIERS), "--batch-size", "128"],
                         filip_engine)
    blocks = filip_captured_blocks(run, data_dir)
    k4 = check_filip_tier_k4(blocks, fault_libs, gen, long_rows=True)
    mcfg, _ = filip_setup()
    heads0 = filip.init_params(mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    cfg, batch = filip_first_batch(data_dir, run["args"])
    n = filip_k4_blocks(batch)
    lk, gk, nk = filip_step(cfg, batch, heads0)
    lp, gp, np_ = filip_step(cfg, batch, heads0, plain_maxsim)
    scale = max(float(g.abs().max()) for g in gp.values())
    loss_err = abs(lk - lp) / abs(lp)
    grad_err = max(float((gk[k] - gp[k]).abs().max()) / scale for k in gp)
    ok = (nk, np_) == (n, 0) and max(loss_err, grad_err) <= FILIP_STEP_TOL
    log(f"[tiers] packed FILIP at 128 in width tiers: {len(blocks)} K4 blocks on the first batch "
        f"({n} launches a step: {tier_layout(batch)}); one step through filip_maxsim vs its plain "
        f"version: loss {lk:.7f} vs {lp:.7f}, relative |err| {loss_err:.3g}, gradients "
        f"{grad_err:.3g} of the step's largest (tolerance {FILIP_STEP_TOL:g}); launches {nk}, {np_} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the tiered packed FILIP step disagrees with the plain max-sim")
    return {**run, "blocks": len(blocks), "k4_launches_per_step": n, "k4": k4,
            "step_check": {"loss_rel_err": loss_err, "grad_rel_err": grad_err}}


def run_mlm(name: str, extra: list[str]) -> dict:
    """cli.mlm_train for one epoch at --batch-size MLM_BATCH on the
    1100-family fixture (receptors): the CSV and best_model.npz, and the
    launches: one backbone forward a batch, K1 30 a forward (60 a
    --finetune step: forward and remat recompute), K5 30 a --finetune
    step; no other kernel."""
    data_dir = WORK / SMALL_DATA
    runs = WORK / f"runs_{name}"
    unfrozen = "--finetune" in extra
    t0 = time.perf_counter()
    with counted_forwards() as forwards:
        reset_counts()
        mlm_train.main(["--synthetic-fixture", "--data-dir", str(data_dir), "--fixture-families",
                        str(SMALL_FIXTURE_FAMILIES), "--epochs", "1", "--runs-dir", str(runs),
                        "--batch-size", str(MLM_BATCH)] + extra)
        got = kernel_counts(counts())
        check_default_path(name)
    wall = time.perf_counter() - t0
    (run,) = list(runs.iterdir())
    rows = (run / "losses_per_epoch.txt").read_text().splitlines()
    if (sorted(p.name for p in run.iterdir()) != ["best_model.npz", "losses_per_epoch.txt"]
            or len(rows) != 2 or not all(math.isfinite(float(v)) for v in rows[1].split(",")[1:])):
        raise AssertionError(f"{name}: {sorted(p.name for p in run.iterdir())}, {rows}")
    train_ds, val_ds, _ = dataset.generate_datasets(data_dir, seed=42)
    steps, evals = len(train_ds) // MLM_BATCH, len(val_ds) // MLM_BATCH
    want = {"attention_fwd": 30 * (steps + evals) + (30 * steps if unfrozen else 0)}
    if unfrozen:
        want["attention_bwd"] = 30 * steps
    if len(forwards) != steps + evals or got != want:
        raise AssertionError(f"{name}: {len(forwards)} forwards (want {steps + evals}), "
                             f"launches {got} (want {want})")
    log(f"[mlm] {name} ({' '.join(extra) or 'the head alone, padded rows'}): {steps} steps, "
        f"{evals} eval batches of {MLM_BATCH} receptors; losses {rows[1]}; forwards (rows, L) "
        f"{forwards[:2]} ...; launches {got}; cli.mlm_train {wall:.2f} s")
    return {"run": run, "steps": steps, "evals": evals, "launches": got, "seconds": wall}


def mlm_batch(packed: bool) -> dict:
    """The first MLM_BATCH receptors of the fixture's train split, as
    cli.mlm_train's first batch, on the card (batch_inputs)."""
    train_ds, _, _ = dataset.generate_datasets(WORK / SMALL_DATA, seed=42)
    _, recs = next(iter(dataset.PairLoader(train_ds, MLM_BATCH, seed=42)))
    tok = common.make_tokenizer()
    if packed:
        arrs = (packed_engine.tokenize_packed_rows(tok, recs),)
    else:
        enc = tok(recs)
        arrs = (torch.from_numpy(enc["input_ids"]), torch.from_numpy(enc["attention_mask"]))
    return mlm_train.batch_inputs(to_device(arrs, "cuda"), packed)


def mlm_step(mode: str, inputs: dict, masks: tuple, attention_cm=contextlib.nullcontext) -> tuple:
    """One cli.mlm_train step of ``mode`` (head or finetune, Adam lr 1e-3)
    from the run's weights (seed 0 backbone, seed 42 head) on fixed masks:
    (loss, gradients by leaf)."""
    cfg_esm = common.esm_config("t30_150M", "bfloat16")
    esm_params = esm2.init_params(cfg_esm, torch.Generator(device="cuda").manual_seed(0),
                                  dtype=torch.bfloat16, device="cuda")
    head = esm2.init_lm_head(cfg_esm, torch.Generator().manual_seed(42), device="cuda")
    args = argparse.Namespace(seed=42, lora_rank=0, lora_ffn=False, lr=1e-3, weight_decay=0.0,
                              warmup_steps=0, lr_schedule="constant", grad_clip=0.0,
                              backbone_lr=None)
    trainable, view, group = mlm_train.trainable_tree(args, mode, head, esm_params, cfg_esm,
                                                      "cuda")
    if mode == "finetune":
        esm_params = {}
    state = capturing(mlm_train.make_optimizer(args, mode, group, 1).init(trainable), trainable)
    step, _ = mlm_train.make_steps(cfg_esm, mode, view)
    with attention_cm():
        _, _, loss = step(trainable, state, esm_params, inputs, masks)
    torch.cuda.synchronize()
    return float(loss), state.grads


def check_mlm_steps(fault_libs: dict) -> dict:
    """On cli.mlm_train's first packed batch with masks fixed by a seeded
    generator: the head step through K1 against the same step through K1's
    plain version (loss within MLM_LOSS_RTOL relative); the --finetune
    step through K1/K5 against K1 and K5's plain version (the loss within
    FT_LOSS_TOL, every leaf within MLM_FT_K5_TOL of its largest entry),
    K5's swept-tile fault past that; the finetune step's peak memory (its
    weights and Adam state included)."""
    inputs = mlm_batch(packed=True)
    masks = mlm_train.draw_masks(torch.Generator(device="cuda").manual_seed(SEED), inputs, 0.15)
    lk, _ = mlm_step("head", inputs, masks)
    lp, _ = mlm_step("head", inputs, masks, lambda: attention_function(plain_forward,
                                                                       plain_backward))
    head_err = abs(lk - lp) / abs(lp)
    gc.collect()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fk, gk = mlm_step("finetune", inputs, masks)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    fp, gp = mlm_step("finetune", inputs, masks,
                      lambda: attention_function(attention._forward, plain_backward))
    with attention_kernels(fault_libs["swept_tiles"],
                           (attention._kernel("attention_bwd", torch.bfloat16),)):
        ff, gf = mlm_step("finetune", inputs, masks)
    gaps = {k: float((gk[k] - gp[k]).abs().max()) / float(gp[k].abs().max()) for k in gp}
    fault = max(float((gf[k] - gp[k]).abs().max()) / float(gp[k].abs().max()) for k in gp)
    worst = max(gaps, key=gaps.get)
    loss_err = abs(fk - fp) / abs(fp)
    ok = head_err <= MLM_LOSS_RTOL and loss_err <= FT_LOSS_TOL and gaps[worst] <= MLM_FT_K5_TOL \
        and fault > MLM_FT_K5_TOL
    log(f"[mlm] one step on the first packed batch ({tuple(inputs['ids'].shape)}, "
        f"{int((masks[1] != -100).sum())} masked tokens): the head step through K1 vs K1's plain "
        f"version: loss {lk:.6f} vs {lp:.6f}, relative |err| {head_err:.3g} (tolerance "
        f"{MLM_LOSS_RTOL:g}); the finetune step through K1/K5 vs K5's plain version: loss "
        f"relative |err| {loss_err:.3g} (tolerance {FT_LOSS_TOL:g}), worst leaf {worst} "
        f"{gaps[worst]:.4g} (tolerance {MLM_FT_K5_TOL:g}), the swept-tile fault {fault:.4g}; peak "
        f"memory of the finetune step {peak:.4f} GB {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the MLM steps disagree with their plain attention")
    return {"head_loss_rel_err": head_err, "finetune_loss_rel_err": loss_err,
            "finetune_worst_leaf": worst, "finetune_leaf_gap": gaps[worst],
            "fault_leaf_gap": fault, "finetune_peak_memory_gb": peak}


def run_mlm_phase(fault_libs: dict) -> dict:
    """The three cli.mlm_train runs, the step checks and cli.mlm_sweep."""
    out = {"runs": {name: run_mlm(name, extra) for name, extra in MLM_RUNS}}
    out["steps"] = timed("check_mlm_steps", check_mlm_steps, fault_libs)
    runs = WORK / "runs_mlm_sweep"
    mlm_sweep.main(["--synthetic-fixture", "--data-dir", str(WORK / SMALL_DATA), "--runs-dir",
                    str(runs), "--n-sequences", "200"])
    (run,) = list(runs.iterdir())
    data = np.load(run / "figures" / "figure 1.npy")
    if data.shape != (6, 200) or not ((0 <= data) & (data <= 1)).all():
        raise AssertionError(f"cli.mlm_sweep wrote {data.shape}")
    means = data.mean(1)
    if not np.all(np.diff(means) > 0):
        raise AssertionError(f"the sweep's changed fractions do not grow with p: {means}")
    log(f"[mlm] cli.mlm_sweep over 200 peptides: mean changed fraction {np.round(means, 4)} at "
        f"p = 0.05 ... 0.5")
    out["sweep_means"] = means.tolist()
    return out


def time_tier_chunks(segments: list, gen: torch.Generator, gpu: str) -> list[dict]:
    """K1 (as the backbone calls it in a frozen step: no statistics) on the
    tier chunks of the tiered run's first batch, in device time by
    kernel_times, beside its bound on the chunk's own segments."""
    clock = sm_clock_hz()
    rows = []
    for kind, seg in segments:
        q, k, v = qkv(*seg.shape, gen)
        t = kernel_times(lambda: attention.fused_attention(q, k, v, seg), 30)
        row = {"shape": list(seg.shape), "kind": kind, "ms": t["device_ms"],
               "wall_ms": t["events_ms"], **attention_bound(seg, False, clock)}
        row.pop("counts")
        log(f"[time] attention_fwd on the {kind} {tuple(seg.shape)}: {row['ms']:.6f} ms device "
            f"time (CUDA events {row['wall_ms']:.6f}), bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}) | {gpu}")
        rows.append(row)
    return rows


def sm_clock_hz() -> float:
    """The card's largest SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def attention_work(seg: torch.Tensor) -> dict:
    """What one head of the function needs on these segments, summed over
    the rows: allowed (query, key) pairs, valid tokens (segment > 0), pad
    tokens, and tokens of the rows that hold a pad (a pad query's output is
    the mean of v over all T keys, with no exponential)."""
    T = seg.shape[1]
    allowed = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    pads = (seg <= 0).sum(1)
    return {"pairs": int(allowed.sum()), "valid": int((seg > 0).sum()), "pads": int(pads.sum()),
            "padded_rows_tokens": T * int((pads > 0).sum())}


def attention_bound(seg: torch.Tensor, backward: bool, clock_hz: float, nh: int = NH,
                    dh: int = DH) -> dict:
    """K1's (or K5's) bound on this run's segments, one head's work times
    NH. Operations: bf16 tensor-core FLOPs over the allowed pairs (K1: S and
    P.V; K5: S, dP, dq, dk, dv), and f32 adds for the pad queries' closed
    form (K1: the column sum of v, T*32 per (row, head) with a pad; K5: the
    sum of the pads' dO and its add to every key's dv, (pads + T)*32).
    Bytes moved once: K1 reads q and k of valid tokens and v of every
    token (a row without pads has no other; a pad query's mean reads all of
    its row) and writes o; K5 reads q, k and v
    of valid tokens and dO of every token and writes dq, dk and dv; both
    read the segments. No statistics: the TPU-form function has none.
    Beside them the exponential floor: one exp per allowed pair at 16 ex2
    per clock on each of the 132 SMs, at clocks.max.sm. At nh heads of dh
    (the function's own dh: 24, not the kernels' 32-wide tiles)."""
    B, T = seg.shape
    w = attention_work(seg)
    row = nh * dh * 2                              # bytes of one token's heads
    if backward:
        flops = nh * 5 * 2 * dh * w["pairs"]
        adds = nh * dh * (w["pads"] + w["padded_rows_tokens"])
        nbytes = row * (3 * w["valid"] + 4 * B * T) + B * T * 4
    else:
        flops = nh * 2 * 2 * dh * w["pairs"]
        adds = nh * dh * w["padded_rows_tokens"]
        nbytes = row * (2 * w["valid"] + 2 * B * T) + B * T * 4
    t_ops = flops / H100_BF16_FLOPS + adds / H100_F32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S
    exp_ms = 1e3 * nh * w["pairs"] / (132 * 16 * clock_hz)
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "exp_floor_ms": exp_ms, "allowed_share": w["pairs"] / (B * T * T),
            "counts": f"{flops / 1e9:.4f} GFLOP bf16 and {adds / 1e6:.4f} M f32 adds, "
                      f"{nbytes / 1e6:.4f} MB, {nh * w['pairs'] / 1e6:.4f} M exponentials at "
                      f"{clock_hz / 1e9:.3f} GHz"}


def dense_segments(B: int, T: int) -> torch.Tensor:
    return torch.ones(B, T, dtype=torch.int32, device="cuda")


def time_attention(gen: torch.Generator, gpu: str) -> dict:
    """K1 (as serving calls it, without statistics), K1 with its statistics,
    its plain version and torch's scaled_dot_product_attention with the same
    boolean mask, at B=16, T=512, NH=20: padded rows, then every token in
    one segment (the dense row, where no tile is skipped); in device time
    by kernel_times, K1's CUDA events beside it (a call's host work, some
    50 us, can outlast K1's device time)."""
    B, T = 16, 512
    clock = sm_clock_hz()
    rows = {}
    for kind, seg in (("padded", padded_segments(B, T)), ("dense", dense_segments(B, T))):
        # four input sets (4 x 42 MB) so that successive calls miss the 50 MB L2
        sets = [qkv(B, T, gen) for _ in range(4)]
        allowed = ((seg[:, None, :, None] == seg[:, None, None, :])
                   & (seg[:, None, None, :] > 0))
        cycle = itertools.cycle(sets)

        def library():
            q, k, v = (x.transpose(1, 2) for x in next(cycle))
            torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=allowed,
                                                             scale=1.0)

        k1 = kernel_times(lambda: attention.fused_attention(*next(cycle), seg), 100)
        row = {"shape": [B, T, NH, DH], "segments": kind, "ms": k1["device_ms"],
               "wall_ms": k1["events_ms"], "records": k1["records"],
               "with_lse_ms": kernel_times(lambda: attention._forward(*next(cycle), seg, True),
                                           100)["device_ms"],
               "plain_ms": kernel_times(lambda: attention.attention_reference(*next(cycle), seg),
                                        10)["device_ms"],
               "library_ms": kernel_times(library, 50)["device_ms"],
               **attention_bound(seg, False, clock)}
        counts = row.pop("counts")
        log(f"[time] attention_fwd B={B} T={T} NH={NH} {kind}, device time: kernel "
            f"{row['ms']:.6f} ms ({row['records']:g} kernel records kept a call; CUDA events "
            f"{row['wall_ms']:.6f} ms; {row['with_lse_ms']:.6f} ms writing its statistics), "
            f"plain {row['plain_ms']:.6f} "
            f"ms, library (scaled_dot_product_attention) {row['library_ms']:.6f} ms, bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']}: {counts}; allowed pairs "
            f"{row['allowed_share']:.4f} of T^2), exponential floor {row['exp_floor_ms']:.6f} ms "
            f"| {gpu}")
        rows[kind] = row
    return {**rows["padded"], "dense": rows["dense"]}


def time_attention_bwd(gen: torch.Generator, gpu: str, packed: list = ()) -> list[dict]:
    """K5 (fed K1's statistics), its plain version, and the backward alone
    of torch's scaled_dot_product_attention with the same boolean mask (a
    yardstick: torch.autograd.grad on a saved graph), at K5_TIME_SHAPES
    padded, at (16, 512) dense and on the packed chunks ``packed`` ((kind,
    segments) pairs), in device time by kernel_times (torch.profiler's
    records, each kernel's mean times its launches, beside the records
    kept, CUDA events and the SM clock): at the chunk shapes the wrapper's
    host work (checks, allocations, ctypes) outlasts the kernels."""
    rows = []
    clock = sm_clock_hz()
    shapes = ([(padded_segments(B, T), "padded") for B, T in K5_TIME_SHAPES]
              + [(dense_segments(16, 512), "dense")] + [(seg, kind) for kind, seg in packed])
    for seg, kind in shapes:
        B, T = seg.shape
        allowed = ((seg[:, None, :, None] == seg[:, None, None, :])
                   & (seg[:, None, None, :] > 0))
        # input sets enough that successive calls miss the 50 MB L2 (one set
        # at (28, 2048) is 294 MB)
        sets = []
        for _ in range(4 if B * T <= 16 * 512 else 1):
            q, k, v = qkv(B, T, gen)
            do = torch.randn(B, T, NH, DH, device="cuda", generator=gen).bfloat16()
            lse = attention._forward(q, k, v, seg, with_lse=True)[1]
            lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            out = torch.nn.functional.scaled_dot_product_attention(lq, lk, lv, attn_mask=allowed,
                                                                   scale=1.0)
            sets.append((q, k, v, do, lse, (out, (lq, lk, lv), do.transpose(1, 2))))
        cycle = itertools.cycle(sets)

        def kernel():
            q, k, v, do, lse, _ = next(cycle)
            attention.fused_attention_bwd(q, k, v, seg, do, lse)

        def plain():
            q, k, v, do, _, _ = next(cycle)
            by_rows(attention.attention_reference_bwd, q, k, v, seg, do)

        def library():
            out, inputs, do = next(cycle)[5]
            torch.autograd.grad(out, inputs, do, retain_graph=True)

        k5, k5_plain, sdpa = (kernel_times(kernel, 100), kernel_times(plain, 10),
                              kernel_times(library, 100))
        row = {"shape": [B, T, NH, DH], "segments": kind, "ms": k5["device_ms"],
               "wall_ms": k5["events_ms"], "records": k5["records"],
               "kept_ms": k5["kept_ms"], "clock_mhz": k5["clock_mhz"],
               "plain_ms": k5_plain["device_ms"], "plain_records": k5_plain["records"],
               "library_ms": sdpa["device_ms"], "library_records": sdpa["records"],
               **attention_bound(seg, True, clock)}
        counts = row.pop("counts")
        log(f"[time] attention_bwd B={B} T={T} NH={NH} {kind}, device time: kernel "
            f"{row['ms']:.6f} ms ({row['records']:g} kernel records kept a call, "
            f"{row['kept_ms']:.6f} ms their sum; {row['wall_ms']:.6f} ms per call with the host; "
            f"SM clock {row['clock_mhz']} MHz), plain {row['plain_ms']:.6f} ms "
            f"({row['plain_records']:g} records a call), library "
            f"(scaled_dot_product_attention backward) {row['library_ms']:.6f} ms "
            f"({row['library_records']:g} records a call), bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
            f"{counts}; allowed pairs {row['allowed_share']:.4f} of T^2) = "
            f"{100 * row['bound_ms'] / row['ms']:.2f}% of the bound, exponential floor "
            f"{row['exp_floor_ms']:.6f} ms | {gpu}")
        rows.append(row)
    return rows


def time_attention_families(gen: torch.Generator, gpu: str) -> list[dict]:
    """K1 and K5 at t30_150M's (16, 512, 20, 32), the baseline measured in
    the same loop, and at each other family's attention shape
    (FAMILY_SHAPES), padded: K1 (its output alone, as serving calls it),
    its plain version and scaled_dot_product_attention with the same
    boolean mask; K5 fed K1's statistics, its plain version and SDPA's
    backward; all in device time by kernel_times (as time_attention,
    time_attention_bwd and tools/probe_attention.py time them: each
    kernel's mean record times its launches, beside the records kept, CUDA
    events and the SM clock); each beside its bound on the run's segments
    at the function's head dim."""
    clock = sm_clock_hz()
    rows = []
    for B, T, nh, dh in ((16, 512, NH, DH),) + FAMILY_SHAPES:
        seg = padded_segments(B, T)
        allowed = ((seg[:, None, :, None] == seg[:, None, None, :])
                   & (seg[:, None, None, :] > 0))
        sets = []
        for _ in range(4):      # successive calls miss the 50 MB L2
            q, k, v = qkv(B, T, gen, nh, dh)
            do = torch.randn(B, T, nh, dh, device="cuda", generator=gen).bfloat16()
            lse = attention._forward(q, k, v, seg, with_lse=True)[1]
            lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            out = torch.nn.functional.scaled_dot_product_attention(lq, lk, lv, attn_mask=allowed,
                                                                   scale=1.0)
            sets.append((q, k, v, do, lse, (out, (lq, lk, lv), do.transpose(1, 2))))
        cycle = itertools.cycle(sets)

        def sdpa():
            q, k, v = (x.transpose(1, 2) for x in next(cycle)[:3])
            torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=allowed,
                                                             scale=1.0)

        def k5():
            q, k, v, do, lse, _ = next(cycle)
            attention.fused_attention_bwd(q, k, v, seg, do, lse)

        def k5_plain():
            q, k, v, do, _, _ = next(cycle)
            attention.attention_reference_bwd(q, k, v, seg, do)

        def sdpa_bwd():
            out, inputs, do = next(cycle)[5]
            torch.autograd.grad(out, inputs, do, retain_graph=True)

        k1_t = kernel_times(lambda: attention.fused_attention(*next(cycle)[:3], seg), 100)
        fwd = {"ms": k1_t["device_ms"], "records": k1_t["records"],
               "events_ms": k1_t["events_ms"],
               "plain_ms": kernel_times(lambda: attention.attention_reference(*next(cycle)[:3],
                                                                            seg),
                                        10)["device_ms"],
               "library_ms": kernel_times(sdpa, 50)["device_ms"],
               **attention_bound(seg, False, clock, nh, dh)}
        k5_t, plain_t, sdpa_t = (kernel_times(k5, 100), kernel_times(k5_plain, 10),
                                 kernel_times(sdpa_bwd, 50))
        bwd = {"ms": k5_t["device_ms"], "records": k5_t["records"], "kept_ms": k5_t["kept_ms"],
               "events_ms": k5_t["events_ms"], "clock_mhz": k5_t["clock_mhz"],
               "plain_ms": plain_t["device_ms"], "plain_records": plain_t["records"],
               "library_ms": sdpa_t["device_ms"], "library_records": sdpa_t["records"],
               **attention_bound(seg, True, clock, nh, dh)}
        for name, row in (("attention_fwd", fwd), ("attention_bwd", bwd)):
            counts = row.pop("counts")
            how = (f" ({row['records']:g} kernel records kept a call; CUDA events "
                   f"{row['events_ms']:.6f} ms)" if name == "attention_fwd" else
                   f" ({row['records']:g} kernel records kept a call, {row['kept_ms']:.6f} ms "
                   f"their sum; CUDA events {row['events_ms']:.6f} ms; SM clock "
                   f"{row['clock_mhz']} MHz; plain {row['plain_records']:g} and library "
                   f"{row['library_records']:g} records a call)")
            log(f"[time] {name} B={B} T={T} NH={nh} DH={dh} padded: kernel {row['ms']:.6f} ms{how}, "
                f"plain {row['plain_ms']:.6f} ms, library (scaled_dot_product_attention"
                f"{' backward' if name == 'attention_bwd' else ''}) {row['library_ms']:.6f} ms, "
                f"bound {row['bound_ms']:.6f} ms ({row['bound_by']}: {counts}; allowed pairs "
                f"{row['allowed_share']:.4f} of T^2) = {100 * row['bound_ms'] / row['ms']:.2f}% "
                f"of the bound, exponential floor {row['exp_floor_ms']:.6f} ms | {gpu}")
        rows.append({"shape": [B, T, nh, dh], "segments": "padded", "attention_fwd": fwd,
                     "attention_bwd": bwd})
    return rows


def maxsim_work(ma: torch.Tensor, mb: torch.Tensor, D: int) -> dict:
    """What K4 needs on these masks: the token pairs both masks allow
    (ma * mb > 0), the operations of their products kept at f32 accuracy on
    the tensor cores (three TF32 products of 2 D operations each), and the
    bytes of the valid tokens of ha and hb (mask nonzero), both masks and
    both outputs, each moved once."""
    pa, na = float((ma > 0).sum()), float((ma < 0).sum())
    pb, nb = float((mb > 0).sum()), float((mb < 0).sum())
    pairs = pa * pb + na * nb
    tokens = int((ma != 0).sum()) + int((mb != 0).sum())
    return {"pairs": pairs, "flops": 3 * 2 * D * pairs,
            "bytes": 4 * D * tokens + 4 * (ma.numel() + mb.numel())
            + 8 * ma.shape[0] * mb.shape[0]}


def maxsim_bound(ma: torch.Tensor, mb: torch.Tensor, D: int) -> tuple[float, str, str]:
    """(bound ms, what bounds it, the counts) of maxsim_work at the dense
    TF32 peak and the memory rate."""
    work = maxsim_work(ma, mb, D)
    t_ops, t_bytes = work["flops"] / H100_TF32_FLOPS, work["bytes"] / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
            f"{work['flops'] / 1e9:.4f} GFLOP over {work['pairs']:.6g} allowed pairs "
            f"({work['pairs'] / (ma.numel() * mb.numel()):.4f} of all), "
            f"{work['bytes'] / 1e6:.4f} MB")


def time_maxsim(gen: torch.Generator, gpu: str) -> list[dict]:
    """K4 and its plain version at K4_TIME_SHAPES, beside the bound on
    the same masks and the ceiling of an f32 FFMA design (every token pair
    at the CUDA cores' peak): the wrapper's call by CUDA events, and the
    kernel's own device time by torch.profiler. No single PyTorch call
    computes masked max-sim, so there is no library time."""
    rows = []
    for (Ba, Bb, TA, TB), iters in zip(K4_TIME_SHAPES, (50, 50, 5)):
        ha, hb, ma, mb = maxsim_inputs(Ba, Bb, TA, TB, gen)
        ms = cuda_ms(lambda: maxsim.filip_similarity_fused(ha, hb, ma, mb, 1.0), iters)
        kernel_ms = device_ms(lambda: maxsim.filip_similarity_fused(ha, hb, ma, mb, 1.0), iters,
                              kernel="filip_maxsim_kernel")
        plain_ms = cuda_ms(lambda: maxsim.maxsim_reference(ha, hb, ma, mb), 3, warmup=1)
        bound_ms, bound_by, counts = maxsim_bound(ma, mb, FILIP_D)
        ffma_ms = 1e3 * 2 * Ba * Bb * TA * TB * FILIP_D / H100_F32_FLOPS
        log(f"[time] filip_maxsim (Ba, Bb, TA, TB)=({Ba}, {Bb}, {TA}, {TB}) D={FILIP_D}: "
            f"call {ms:.6f} ms (kernel's device time {kernel_ms:.6f}), plain {plain_ms:.6f} ms, "
            f"library none, bound {bound_ms:.6f} ms ({bound_by}: {counts}; TF32 peak "
            f"{H100_TF32_FLOPS / 1e12:g} TFLOP/s) = {100 * bound_ms / ms:.2f}% of the bound "
            f"({100 * bound_ms / kernel_ms:.2f}% by device time); an f32 FFMA design's "
            f"ceiling {ffma_ms:.6f} ms | {gpu}")
        rows.append({"shape": [Ba, Bb, TA, TB, FILIP_D], "ms": ms, "device_ms": kernel_ms,
                     "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
                     "bound_by": bound_by, "ffma_ceiling_ms": ffma_ms})
    return rows


def time_serving(ctx: dict, rng: np.random.Generator, gpu: str, what: str = "bf16") -> dict:
    """/embed p50 for one sequence, the same encode without HTTP, and seqs/s
    at batch 32, against ctx's server and backbone."""
    base = ctx["base"]
    one = synthetic_seqs(rng, [100])
    for _ in range(3):
        embed_json(base, one, "rec")
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        embed_json(base, one, "rec")
        lat.append(1e3 * (time.perf_counter() - t0))
    out = {"embed_p50_ms": statistics.median(lat)}
    log(f"[time] {what} /embed 1 sequence (100 aa, bucket 128): p50 {out['embed_p50_ms']:.4f} "
        f"ms over 30 requests | {gpu}")
    # the same encode without HTTP and the coalescer: what those layers add
    tok = common.make_tokenizer()
    direct = []
    for _ in range(30):
        t0 = time.perf_counter()
        embed.embed_sequences(ctx["heads"], ctx["esm_params"], one, "rec", ctx["mcfg"], tok,
                              torch.device("cuda"), batch_size=32, pad_batch=True)
        direct.append(1e3 * (time.perf_counter() - t0))
    out["encode_p50_ms"] = statistics.median(direct)
    log(f"[time] {what} embed_sequences 1 sequence without HTTP: p50 "
        f"{out['encode_p50_ms']:.4f} ms over 30 calls | {gpu}")
    batch = ctx["batch32"]
    embed_json(base, batch, "rec")
    dts = []
    for _ in range(10):
        t0 = time.perf_counter()
        embed_json(base, batch, "rec")
        dts.append(time.perf_counter() - t0)
    out["batch32_seqs_per_s"] = 32 / statistics.median(dts)
    log(f"[time] {what} /embed batch 32 (50-299 aa): {out['batch32_seqs_per_s']:.4f} seqs/s "
        f"(median of 10 requests) | {gpu}")
    return out


def time_filip_serving(ctx: dict, fctx: dict, rng: np.random.Generator, gpu: str) -> None:
    """/topk --filip for one query, and its parts called without HTTP: the
    token encode, the ragged scorer (host densify + copy + kernel), and the
    kernel alone at the scorer's shape."""
    base = fctx["base"]
    one = synthetic_seqs(rng, [100])
    before = maxsim.filip_similarity_fused.launches
    for _ in range(3):
        post_json(base, "/topk", {"queries": one, "side": "pep", "k": 10})
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        post_json(base, "/topk", {"queries": one, "side": "pep", "k": 10})
        lat.append(1e3 * (time.perf_counter() - t0))
    launches = maxsim.filip_similarity_fused.launches - before
    log(f"[time] /topk --filip 1 query (100 aa, bucket 128) over 256 sequences, k=10: p50 "
        f"{statistics.median(lat):.4f} ms over 30 requests; {launches} filip_maxsim launches "
        f"in 33 requests | {gpu}")

    tok, dev = common.make_tokenizer(), torch.device("cuda")

    def p50(fn, n=30):
        dts = []
        for _ in range(n + 3):
            t0 = time.perf_counter()
            fn()
            dts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(dts[3:])

    q_t, q_m = embed.embed_sequences_tokens(fctx["fheads"], ctx["esm_params"], one, "pep",
                                            fctx["fcfg"], tok, dev, batch_size=32,
                                            pad_batch=True)
    encode_ms = p50(lambda: embed.embed_sequences_tokens(
        fctx["fheads"], ctx["esm_params"], one, "pep", fctx["fcfg"], tok, dev,
        batch_size=32, pad_batch=True))
    with np.load(fctx["index_path"]) as index:
        flat, lengths = index["tokens"], index["lengths"]
    t = fctx["fheads"]["temperature"]
    scorer_ms = p50(lambda: retrieval.filip_score_matrix_ragged(q_t, q_m, flat, lengths, t,
                                                                device=dev))
    tb = 64 * math.ceil(int(lengths.max()) / 64)
    hb = torch.zeros(len(lengths), tb, FILIP_D, device=dev)
    mb = (torch.arange(tb, device=dev)[None, :]
          < torch.from_numpy(lengths).to(dev)[:, None]).to(torch.int32)
    qt, qm = torch.from_numpy(q_t).to(dev), torch.from_numpy(q_m).to(dev).to(torch.int32)
    kernel_ms = cuda_ms(lambda: maxsim.filip_similarity_fused(qt, hb, qm, mb, t), 50)
    log(f"[time] /topk --filip parts without HTTP, p50 of 30 calls: token encode "
        f"{encode_ms:.4f} ms; ragged scorer {scorer_ms:.4f} ms, of which the kernel at "
        f"(1, {len(lengths)}, {q_t.shape[1]}, {tb}) takes {kernel_ms:.6f} ms and the host "
        f"densify, copies and sync {scorer_ms - kernel_ms:.4f} ms | {gpu}")
    corpus = fctx["corpus"]
    dts = []
    for _ in range(3):
        t0 = time.perf_counter()
        embed.embed_sequences_tokens_ragged(fctx["fheads"], ctx["esm_params"], corpus, "rec",
                                            fctx["fcfg"], tok, dev, batch_size=32)
        dts.append(time.perf_counter() - t0)
    log(f"[time] embed --filip encode of the 256-sequence corpus (30-499 aa, batch 32, "
        f"ragged): {len(corpus) / statistics.median(dts):.4f} seqs/s (median of 3) | {gpu}")


def device_ms(fn, iters: int, warmup: int = 3, kernel: str = "") -> float:
    """Device time of fn() per call: the CUDA kernels' self time summed by
    torch.profiler over iters calls (only those whose name holds `kernel`).
    Host work between launches (autograd, allocation, ctypes) is left out;
    cuda_ms includes it. Where no session keeps a record, the whole call's
    device time by graph replay (tools/timing.graph_ms), which the log says."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # Now and then a profiler session records no device events at all (seen
    # once in a run on an H100, at a step that had timed fine before): such
    # a session is taken again, at most twice.
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages() if kernel in e.key)
        if total_us > 0:
            return total_us / 1e3 / iters
    ms = graph_ms(fn, iters)
    log(f"[time] torch.profiler recorded no device time{f' of {kernel}' if kernel else ''} in "
        f"3 sessions: the whole call's device time by graph replay, {ms:.6f} ms")
    return ms


def infonce_bound(B: int, D: int) -> tuple[float, str, str]:
    """(bound ms, what bounds it, the counts) of forward plus backward: the
    logits, dX and dY, each product kept at f32 accuracy as three TF32
    products on the tensor cores (18 B^2 D operations at the TF32 peak),
    against x, y read and dX, dY, the loss written once."""
    ops = 18 * B * B * D
    nbytes = 16 * B * D + 4
    t_ops, t_bytes = ops / H100_TF32_FLOPS, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
            f"{ops / 1e9:.4f} GFLOP TF32, {nbytes / 1e6:.4f} MB")


def infonce_ceiling(B: int, D: int) -> float:
    """The ceiling of the FFMA design K2 and K3 had before (ms): 6 B^2 D f32
    FLOP on the CUDA cores."""
    return 1e3 * 6 * B * B * D / H100_F32_FLOPS


# Numbers the timing rows work out rather than measure: they go to the log
# and PERF.md, never to the kernels line, whose only computed number is
# bound_ms.
COMPUTED_KEYS = ("cuda_core_ceiling_ms", "ffma_ceiling_ms", "launch_floor_ms", "exp_floor_ms")


def measured_only(obj):
    """obj (the kernels line's dicts and lists) without COMPUTED_KEYS."""
    if isinstance(obj, dict):
        return {k: measured_only(v) for k, v in obj.items() if k not in COMPUTED_KEYS}
    if isinstance(obj, list):
        return [measured_only(v) for v in obj]
    return obj


def device_kernels(fn, first: str, iters: int = 20) -> tuple[float, float]:
    """Device kernels per fn() call by torch.profiler: those whose name holds
    "pct_infonce" (the kernels of csrc/infonce.cu) and all device events
    (autograd's fill of the cotangent among them), each over the count of
    the call's first kernel, whose name holds `first` (a session may drop
    whole calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session that keeps no record is taken again, at most twice
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        calls = sum(e.count for e in events if first in e.key)
        if calls:
            break
    else:
        raise AssertionError(f"torch.profiler recorded no {first} kernel in 3 sessions")
    return (sum(e.count for e in events if "pct_infonce" in e.key) / calls,
            sum(e.count for e in events) / calls)


def time_infonce(gen: torch.Generator, gpu: str) -> dict:
    """K2 at (256, 128), K3 at (1024, 128) and (4096, 128), forward plus
    backward through autograd, and the plain clip_infonce the same way;
    beside them the bound, the old design's CUDA-core ceiling, the device
    kernels a call runs (autograd's fill of the cotangent among them) and
    the launch floor: those kernels times an empty kernel's device time
    (torch.cuda._sleep(0)) under the same profiler. No single PyTorch call
    computes symmetric InfoNCE, so there is no library time."""
    empty_ms = device_ms(lambda: torch.cuda._sleep(0), 200)
    rows = {}
    for name, B in (("infonce", 256), ("infonce_tiled", 1024), ("infonce_tiled", 4096)):
        fn = infonce.fused_infonce if name == "infonce" else infonce.fused_infonce_tiled
        x, y = (t.requires_grad_(True) for t in unit_rows(B, 128, 1.0, gen))

        def kernel():
            torch.autograd.grad(fn(x, y), (x, y))

        def plain():
            torch.autograd.grad(infonce.clip_infonce(x, y), (x, y))

        iters = 200 if B <= 1024 else 50
        row = {"shape": [B, 128], "ms": device_ms(kernel, iters),
               "wall_ms": cuda_ms(kernel, iters), "plain_ms": device_ms(plain, iters),
               "plain_wall_ms": cuda_ms(plain, iters), "library_ms": None}
        row["fwd_ms"] = device_ms(lambda: fn(x.detach(), y.detach()), iters)
        row["bound_ms"], row["bound_by"], counts = infonce_bound(B, 128)
        row["cuda_core_ceiling_ms"] = infonce_ceiling(B, 128)
        row["kernels_per_call"], row["device_kernels_per_call"] = device_kernels(
            kernel, "infonce_cluster" if name == "infonce" else "infonce_tiles")
        row["empty_kernel_ms"] = empty_ms
        row["launch_floor_ms"] = row["kernels_per_call"] * empty_ms
        log(f"[time] {name} B={B} D=128 forward+backward: kernel {row['ms']:.6f} ms of device "
            f"time ({row['wall_ms']:.6f} ms per call with the host), forward alone "
            f"{row['fwd_ms']:.6f} ms; plain {row['plain_ms']:.6f} ms ({row['plain_wall_ms']:.6f} "
            f"ms with the host); library none; bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
            f"{counts}; TF32 peak {H100_TF32_FLOPS / 1e12:g} TFLOP/s) = "
            f"{100 * row['bound_ms'] / row['ms']:.2f}% of the bound; the CUDA-core ceiling "
            f"{row['cuda_core_ceiling_ms']:.6f} ms; {row['kernels_per_call']:.4g} kernels of "
            f"csrc/infonce.cu a call ({row['device_kernels_per_call']:.4g} device kernels with "
            f"autograd's), launch floor {row['launch_floor_ms']:.6f} ms (empty kernel "
            f"{empty_ms:.6f} ms) | {gpu}")
        rows.setdefault(name, []).append(row)
    return rows


def time_dispatch(gen: torch.Generator, gpu: str) -> list[dict]:
    """K2 (pools up to its K2_MAX_POOL) and K3 forward+backward on the same
    inputs at each pool of DISPATCH_POOLS: the readings that
    clip_engine.fused_infonce_fits' split rests on (the faster by device
    time, and what the rule picks)."""
    rows = []
    for B in DISPATCH_POOLS:
        x, y = (t.requires_grad_(True) for t in unit_rows(B, 128, 1.0, gen))
        row = {"pool": B, "picked": loss_kernel(B), "infonce": None}
        for name, fn in (("infonce", infonce.fused_infonce),
                         ("infonce_tiled", infonce.fused_infonce_tiled)):
            if name == "infonce" and B > infonce.K2_MAX_POOL:
                continue

            def run():
                torch.autograd.grad(fn(x, y), (x, y))
            row[name] = {"ms": device_ms(run, 100), "wall_ms": cuda_ms(run, 100)}
        row["faster"] = min((k for k in ("infonce", "infonce_tiled") if row[k]),
                            key=lambda k: row[k]["ms"])
        k2 = (f"infonce {row['infonce']['ms']:.6f} ms of device time "
              f"({row['infonce']['wall_ms']:.6f} ms with the host)" if row["infonce"]
              else f"infonce takes pools up to {infonce.K2_MAX_POOL}")
        log(f"[time] dispatch B={B} D=128 forward+backward: {k2}, infonce_tiled "
            f"{row['infonce_tiled']['ms']:.6f} ms ({row['infonce_tiled']['wall_ms']:.6f} ms); "
            f"faster by device time {row['faster']}, the rule picks {row['picked']} | {gpu}")
        rows.append(row)
    return rows


def time_train_steps(tctx: dict, run: str, what: str, gpu: str, pairs: int = 256) -> float:
    """pairs/s of a step of ``pairs`` (global batch 256 by default) over a
    run's steps after the first: the card's time between the events
    recorded after consecutive steps, with no sync inside the epoch."""
    torch.cuda.synchronize()
    ends = tctx[run]["ends"]
    dts = [a.elapsed_time(b) / 1e3 for a, b in zip(ends, ends[1:])]
    rate = pairs / statistics.median(dts)
    log(f"[time] {what} at global batch {pairs} ({tctx[run].get('family', 't30_150M')}): "
        f"{rate:.4f} pairs/s, median of {len(dts)} steps after the first ({1e3 * min(dts):.2f}-"
        f"{1e3 * max(dts):.2f} ms per step, by CUDA events); fixture "
        f"{tctx[run].get('profile') or tctx['profile']} | {gpu}")
    return rate


# ---------------------------------------------------------------------------
# Phases 9-11: the int8 w8a8 backbone (P1) and the fused FFN gate (K6)
# ---------------------------------------------------------------------------

def row_cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def serve_requests(base: str, ctx: dict, what: str) -> dict:
    """/healthz, the single-sequence /embed of phase 3's sequences, its
    32-sequence /embed and /topk over the index (order checked as in phase
    3): {(side, bucket) or "batch32": embeddings}."""
    health = json.loads(call(base, "/healthz")[1])
    if not (health["status"] == "ok" and health["index_size"] == 256):
        raise AssertionError(f"{what} /healthz {health}")
    got = {key: embed_json(base, [seq], key[0])[0] for key, (seq, _) in ctx["singles"].items()}
    got["batch32"] = embed_json(base, ctx["batch32"], "rec")
    queries = ctx["batch32"][:4]
    hits = post_json(base, "/topk", {"queries": queries, "side": "pep", "k": 10})["hits"]
    qemb = embed_json(base, queries, "pep")
    with np.load(WORK / "index.npz") as index:
        ids, corpus = index["ids"], index["embeddings"]
    want = np.argsort(-(qemb @ corpus.T), axis=1)[:, :10]
    for q, row in enumerate(hits):
        if [h["id"] for h in row] != [str(ids[i]) for i in want[q]]:
            raise AssertionError(f"{what} /topk order wrong for query {q}")
    log(f"[{what}] /healthz ok; /embed of {len(ctx['singles'])} single sequences and of 32; "
        f"/topk k=10 over 256: order ok")
    return got


def cosines_against(got: dict, ctx: dict) -> np.ndarray:
    """Per-row cosines of got's embeddings against phase 3's (bf16, gate off)."""
    cos = list(row_cosines(got["batch32"], ctx["emb32"]))
    cos += [float(row_cosines(got[key][None], emb[None])[0])
            for key, (_, emb) in ctx["singles"].items()]
    return np.asarray(cos)


def run_int8_serve_phase(ctx: dict) -> dict:
    """cli.serve --esm-dtype int8 over phase 3's weights and index: launch
    counts (P1 six times a layer, K1 once), the served embeddings against
    the same encode through P1's plain version on the card (equal to the
    bit), and their cosine against the bf16 path."""
    model_args = ctx["model_args"] + ["--esm-dtype", "int8"]
    with counted_forwards() as forwards:
        reset_counts()
        args = serve.build_argparser().parse_args(
            model_args + ["--index", str(WORK / "index.npz"), "--port", "0"])
        server = serve.make_server(args)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        out: dict = {"base": base, "server": server, "thread": thread}
        got = serve_requests(base, ctx, "int8 serve")
        launches = {"dense_mm": dense_mm.mm.launches,
                    "attention_fwd": attention.launches["attention_fwd"], **ffn.launches}
    cfg = common.esm_config("t30_150M", "int8")
    n = len(forwards)
    want = {"dense_mm": 6 * cfg.num_layers * n, "attention_fwd": cfg.num_layers * n,
            **dict.fromkeys(ffn.launches, 0)}
    if not forwards or launches != want:
        raise AssertionError(f"int8 serve: launches {launches} over {n} forwards, want {want}")
    log(f"[int8 serve] {n} backbone forwards: dense_mm {launches['dense_mm']} = "
        f"{6 * cfg.num_layers} per forward (q, k, v, o, wi, wo x {cfg.num_layers} layers), "
        f"attention_fwd {launches['attention_fwd']} = {cfg.num_layers} per forward")
    mcfg = clip.CLIPConfig(input_dim=cfg.hidden_size, esm=cfg)
    qparams = esm2.quantize_params(ctx["esm_params"])
    tok = common.make_tokenizer()
    kernel_mm = dense_mm.mm
    dense_mm.mm = dense_mm.mm_reference
    try:
        plain = {key: embed.embed_sequences(ctx["heads"], qparams, [seq], key[0], mcfg, tok,
                                            torch.device("cuda"), batch_size=32,
                                            pad_batch=True)[0]
                 for key, (seq, _) in ctx["singles"].items()}
        plain["batch32"] = embed.embed_sequences(ctx["heads"], qparams, ctx["batch32"], "rec",
                                                 mcfg, tok, torch.device("cuda"), batch_size=32,
                                                 pad_batch=True)
    finally:
        dense_mm.mm = kernel_mm
    equal = all(np.array_equal(got[k], plain[k]) for k in got)
    cos = cosines_against(got, ctx)
    log(f"[int8 serve] served embeddings against the same encode through dense_mm's plain "
        f"version: {'equal to the bit' if equal else 'DIFFERENT'}; per-row cosine against "
        f"the bf16 path over {len(cos)} rows: min {cos.min():.6f}, median "
        f"{np.median(cos):.6f} (need min >= {INT8_COSINE_MIN})")
    if not equal:
        raise AssertionError("the int8 path through P1 differs from P1's plain version")
    if not cos.min() >= INT8_COSINE_MIN:
        raise AssertionError(f"int8 embeddings drift from bf16: cosine {cos.min()}")
    out.update(launches=launches, cos_min=float(cos.min()), cos_median=float(np.median(cos)),
               heads=ctx["heads"], esm_params=qparams, mcfg=mcfg, batch32=ctx["batch32"])
    return out


def run_int8_train() -> dict:
    """cli.main --esm-dtype int8 for one epoch on a fixture of
    INT8_FIXTURE_FAMILIES families: three frozen steps at global batch 256
    (16 chunks, 4 length groups) and the eval batches; finite losses; P1
    six times a layer per backbone forward, 32 forwards per step, 8 per
    eval batch; K2 once forward and once backward per step."""
    data_dir, runs = WORK / SMALL_DATA, WORK / "runs_int8"
    t0 = time.perf_counter()
    with counted_forwards() as forwards, timed_steps() as ends:
        reset_counts()
        train_cli.main(["--synthetic-fixture", "--data-dir", str(data_dir), "--fixture-families",
                        str(INT8_FIXTURE_FAMILIES), "--epochs", "1", "--runs-dir", str(runs),
                        "--esm-dtype", "int8"])
        p1, k1 = dense_mm.mm.launches, attention.launches["attention_fwd"]
        counts = infonce_counts()
    wall = time.perf_counter() - t0
    run = check_run_dir(runs)
    train_ds, val_ds, test_ds = dataset.generate_datasets(data_dir, seed=42)
    steps = len(train_ds) // 16 // 16
    evals = len(val_ds) // 16 + len(test_ds) // 16
    want_forwards = 32 * steps + 8 * evals
    want = {"infonce": (steps + evals, steps), "infonce_tiled": (0, 0)}
    if (steps != 3 or len(ends) != steps or len(forwards) != want_forwards
            or p1 != 180 * want_forwards or k1 != 30 * want_forwards or counts != want):
        raise AssertionError(f"int8 train: {len(ends)} steps (want {steps} = 3), "
                             f"{len(forwards)} forwards (want {want_forwards}), dense_mm {p1}, "
                             f"attention_fwd {k1}, InfoNCE {counts} (want {want})")
    metrics = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    log(f"[int8 train] cli.main --esm-dtype int8: {steps} steps at global batch 256, {evals} "
        f"eval batches of 16; train loss {metrics['train_loss']:.6f}, val loss "
        f"{metrics['val_loss']:.6f} (finite); {len(forwards)} backbone forwards, dense_mm {p1} "
        f"= 180 per forward, attention_fwd {k1}; InfoNCE (forward, backward) calls {counts}; "
        f"cli.main {wall:.2f} s")
    return {"steps": steps, "ends": ends, "launches": {
        "dense_mm": p1, "attention_fwd": k1, **{k: v[0] for k, v in counts.items()}}}


@contextlib.contextmanager
def ffn_gate():
    os.environ["PCT_FFN_PALLAS"] = "1"
    try:
        yield
    finally:
        del os.environ["PCT_FFN_PALLAS"]


def run_k6_serve_phase(ctx: dict) -> dict:
    """Phase 3's server and requests with PCT_FFN_PALLAS=1 set for the
    phase: K6 once a layer per forward, and the embeddings at cosine >=
    COSINE_MIN per row against the gate off."""
    with ffn_gate(), counted_forwards() as forwards:
        reset_counts()
        got = serve_requests(ctx["base"], ctx, "K6 serve")
        launches = {**ffn.launches, "attention_fwd": attention.launches["attention_fwd"],
                    "dense_mm": dense_mm.mm.launches}
    layers = ctx["mcfg"].esm.num_layers
    n = len(forwards)
    want = {"ffn_gelu": layers * n, "ffn_gelu_f32": 0, "attention_fwd": layers * n,
            "dense_mm": 0}
    if not forwards or launches != want:
        raise AssertionError(f"K6 serve: launches {launches} over {n} forwards, want {want}")
    cos = cosines_against(got, ctx)
    log(f"[K6 serve] {n} backbone forwards: ffn_gelu {launches['ffn_gelu']} = {layers} per "
        f"forward; per-row cosine against the gate off over {len(cos)} rows: min "
        f"{cos.min():.6f}, median {np.median(cos):.6f} (need >= {COSINE_MIN})")
    if not cos.min() >= COSINE_MIN:
        raise AssertionError(f"K6 embeddings drift from the gate off: cosine {cos.min()}")
    return {"launches": launches, "cos_min": float(cos.min())}


def dense_bound(N: int, K: int, M: int, s8: bool) -> tuple[float, str, str]:
    """(bound ms, what bounds it, the counts) of P1: 2NKM operations at the
    int8 or bf16 tensor-core peak, against x and W read and the 4-byte
    output written once."""
    ops = 2 * N * K * M
    e = 1 if s8 else 2
    nbytes = e * (N * K + K * M) + 4 * N * M
    t_ops = ops / (H100_INT8_OPS if s8 else H100_BF16_FLOPS)
    t_bytes = nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
            f"{ops / 1e9:.4f} G{'OP' if s8 else 'FLOP'}, {nbytes / 1e6:.4f} MB")


def time_dense_mm(gen: torch.Generator, gpu: str) -> list[dict]:
    """P1 s8 at the probe's shape and at the batch-32 wi shape against
    torch._int_mm (cuBLASLt s8, given W k-major, the layout cuBLASLt takes
    fast, made once outside the timing: the weights are static), P1 bf16
    against torch.matmul (bf16 out), their plain versions, four input sets
    each so that calls miss the L2."""
    rows = []
    for kind, (N, K, M) in (("s8", (8192, 2560, 2560)), ("s8", (10240, 640, 2560)),
                            ("bf16", (8192, 2560, 2560))):
        s8 = kind == "s8"
        sets = [(s8_pair if s8 else bf16_pair)(N, K, M, gen) for _ in range(4)]
        cycle = itertools.cycle(sets)
        out_dtype = torch.int32 if s8 else torch.float32
        library = torch._int_mm if s8 else torch.matmul
        library_cycle = itertools.cycle([(x, w.t().contiguous().t()) for x, w in sets]
                                        if s8 else sets)
        row = {"kind": kind, "shape": [N, K, M],
               "ms": cuda_ms(lambda: dense_mm.mm(*next(cycle), out_dtype), 50),
               "plain_ms": cuda_ms(lambda: dense_mm.mm_reference(*next(cycle), out_dtype), 5),
               "library_ms": cuda_ms(lambda: library(*next(library_cycle)), 50)}
        row["bound_ms"], row["bound_by"], counts = dense_bound(N, K, M, s8)
        log(f"[time] dense_mm {kind} {(N, K, M)}: kernel {row['ms']:.6f} ms, plain "
            f"{row['plain_ms']:.6f} ms, library ({'torch._int_mm, W k-major' if s8 else 'torch.matmul, bf16 out'}) "
            f"{row['library_ms']:.6f} ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
            f"{counts}) = {100 * row['bound_ms'] / row['ms']:.2f}% of the bound | {gpu}")
        rows.append(row)
    return rows


def time_ffn(gen: torch.Generator, gpu: str) -> dict:
    """K6 at the batch-32 wi shape, its plain version, and torch.addmm
    followed by gelu (two calls: no single PyTorch call computes it)."""
    N, H, M = 10240, 640, 2560
    sets = [ffn_inputs(N, H, M, gen) for _ in range(4)]
    cycle = itertools.cycle(sets)

    def two_calls():
        x, w, b = next(cycle)
        torch.nn.functional.gelu(torch.addmm(b, x, w))

    row = {"shape": [N, H, M],
           "ms": cuda_ms(lambda: ffn.dense_gelu(*next(cycle), "erf"), 50),
           "plain_ms": cuda_ms(lambda: ffn.dense_gelu_reference(*next(cycle), "erf"), 5),
           "library_ms": None, "addmm_gelu_ms": cuda_ms(two_calls, 50)}
    row["bound_ms"], row["bound_by"], counts = ffn_bound(N, H, M)
    log(f"[time] ffn_gelu {(N, H, M)} erf: kernel {row['ms']:.6f} ms, plain "
        f"{row['plain_ms']:.6f} ms, library none (torch.addmm + gelu, two calls: "
        f"{row['addmm_gelu_ms']:.6f} ms), bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
        f"{counts}) = {100 * row['bound_ms'] / row['ms']:.2f}% of the bound | {gpu}")
    return row


def ffn_bound(N: int, H: int, M: int) -> tuple[float, str, str]:
    """(bound ms, what bounds it, the counts) of K6: 2NHM bf16 FLOP against
    x, W, b read and the bf16 output written once."""
    flops = 2 * N * H * M
    nbytes = 2 * (N * H + H * M + M + N * M)
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
            f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.4f} MB")


def ffn_f32_bound(N: int, H: int, M: int) -> tuple[float, str, str, float]:
    """(bound ms, what bounds it, the counts, the FFMA ceiling ms) of
    K6-f32: 2NHM FLOP, each product f32-exact as three TF32 products at the
    TF32 peak, against x, W, b read and the f32 output written once; beside
    it the FFMA design's ceiling, the 2NHM FLOP at the f32 CUDA-core peak."""
    flops = 2 * N * H * M
    nbytes = 4 * (N * H + H * M + M + N * M)
    t_ops, t_bytes = 3 * flops / H100_TF32_FLOPS, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations",
            f"{flops / 1e9:.4f} GFLOP, {3 * flops / 1e9:.4f} GFLOP TF32, {nbytes / 1e6:.4f} MB",
            1e3 * flops / H100_F32_FLOPS)


def time_ffn_f32(N: int, H: int, M: int, gpu: str) -> dict:
    """K6-f32, its plain version and torch.addmm followed by gelu (two
    calls: no single PyTorch call computes it), all f32 with TF32 off, by
    device time (tools/timing.kernel_times), four input sets each so that
    calls miss the L2, beside the 3xTF32 bound and the FFMA ceiling."""
    sets = [ffn_f32_inputs(N, H, M, SEED + 100 + i) for i in range(4)]
    cycle = itertools.cycle(sets)

    def two_calls():
        x, w, b = next(cycle)
        torch.nn.functional.gelu(torch.addmm(b, x, w))

    iters = 50 if N * H * M <= 1 << 30 else 20
    k6 = kernel_times(lambda: ffn.dense_gelu(*next(cycle), "erf"), iters)
    plain = kernel_times(lambda: ffn.dense_gelu_reference(*next(cycle), "erf"), iters)
    lib = kernel_times(two_calls, iters)
    row = {"shape": [N, H, M], "ms": k6["device_ms"], "events_ms": k6["events_ms"],
           "records": k6["records"], "clock_mhz": k6["clock_mhz"],
           "plain_ms": plain["device_ms"], "library_ms": None,
           "addmm_gelu_ms": lib["device_ms"]}
    row["bound_ms"], row["bound_by"], counts, row["ffma_ceiling_ms"] = ffn_f32_bound(N, H, M)
    log(f"[time] ffn_gelu_f32 {(N, H, M)} erf (device time): kernel {row['ms']:.6f} ms (CUDA "
        f"events {row['events_ms']:.6f}, {row['records']:g} records a call, SM clock "
        f"{row['clock_mhz']} MHz), plain {row['plain_ms']:.6f} ms, library none (torch.addmm + "
        f"gelu, f32, TF32 off: {row['addmm_gelu_ms']:.6f} ms), bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}: {counts}) = {100 * row['bound_ms'] / row['ms']:.2f}% of the "
        f"bound, the FFMA ceiling (67 TFLOP/s f32) {row['ffma_ceiling_ms']:.6f} ms = "
        f"{row['ms'] / row['ffma_ceiling_ms']:.3f} x it | {gpu}")
    return row


def time_short_products(gen: torch.Generator, gpu: str) -> dict:
    """P1 s8, K6 and K6-f32 at 128 tokens (a one-sequence request) through
    t30_150M's three layer shapes, beside torch._int_mm (W k-major) and
    torch.addmm + gelu (bf16; f32 with TF32 off), by device time
    (tools/timing.kernel_times: each kernel's mean record times its launches
    a call, so records that torch.profiler loses in this long process do
    not shorten it): at this size a call's host side outlasts its kernel,
    so CUDA events around back-to-back calls would read the host. Beside
    each, the same calls by graph replay (tools/timing.graph_ms), which
    needs no profiler record: `graph_ms` for the kernel, `library_graph_ms`
    for its library or addmm + gelu."""
    rows = {"s8": [], "ffn": [], "ffn_f32": []}
    N = 128
    for K, M in T30_LAYERS:
        sets = [s8_pair(N, K, M, gen) for _ in range(4)]
        cycle = itertools.cycle(sets)
        lib = itertools.cycle([(x, w.t().contiguous().t()) for x, w in sets])
        got = kernel_times(lambda: dense_mm.mm(*next(cycle), torch.int32), 50)
        row = {"shape": [N, K, M], "ms": got["device_ms"], "records": got["records"],
               "library_ms": kernel_times(lambda: torch._int_mm(*next(lib)), 50)["device_ms"]}
        row["graph_ms"] = graph_ms(lambda: dense_mm.mm(*next(cycle), torch.int32), 50)
        row["library_graph_ms"] = graph_ms(lambda: torch._int_mm(*next(lib)), 50)
        row["bound_ms"], row["bound_by"], counts = dense_bound(N, K, M, True)
        rows["s8"].append(row)
        log(f"[time] dense_mm s8 {(N, K, M)} (device time): kernel {row['ms']:.6f} ms "
            f"({row['records']:g} records a call; graph replay {row['graph_ms']:.6f}), library "
            f"(torch._int_mm, W k-major) {row['library_ms']:.6f} ms (graph replay "
            f"{row['library_graph_ms']:.6f}), bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
            f"{counts}) | {gpu}")
        fsets = [ffn_inputs(N, K, M, gen) for _ in range(4)]
        fcycle = itertools.cycle(fsets)

        def two_calls():
            x, w, b = next(fcycle)
            torch.nn.functional.gelu(torch.addmm(b, x, w))

        got = kernel_times(lambda: ffn.dense_gelu(*next(fcycle), "erf"), 50)
        row = {"shape": [N, K, M], "ms": got["device_ms"], "records": got["records"],
               "library_ms": None, "addmm_gelu_ms": kernel_times(two_calls, 50)["device_ms"]}
        row["graph_ms"] = graph_ms(lambda: ffn.dense_gelu(*next(fcycle), "erf"), 50)
        row["library_graph_ms"] = graph_ms(two_calls, 50)
        row["bound_ms"], row["bound_by"], counts = ffn_bound(N, K, M)
        rows["ffn"].append(row)
        log(f"[time] ffn_gelu {(N, K, M)} erf (device time): kernel {row['ms']:.6f} ms "
            f"({row['records']:g} records a call; graph replay {row['graph_ms']:.6f}), library "
            f"none (torch.addmm + gelu: {row['addmm_gelu_ms']:.6f} ms; graph replay "
            f"{row['library_graph_ms']:.6f}), bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
            f"{counts}) | {gpu}")
        row = time_ffn_f32(N, K, M, gpu)
        f32cycle = itertools.cycle([ffn_f32_inputs(N, K, M, SEED + 100 + i) for i in range(4)])

        def two_calls_f32():
            x, w, b = next(f32cycle)
            torch.nn.functional.gelu(torch.addmm(b, x, w))

        row["graph_ms"] = graph_ms(lambda: ffn.dense_gelu(*next(f32cycle), "erf"), 50)
        row["library_graph_ms"] = graph_ms(two_calls_f32, 50)
        log(f"[time] ffn_gelu_f32 {(N, K, M)} erf by graph replay: kernel {row['graph_ms']:.6f} "
            f"ms, torch.addmm + gelu in f32 {row['library_graph_ms']:.6f} ms | {gpu}")
        rows["ffn_f32"].append(row)
    return rows


# ---------------------------------------------------------------------------
# Phase 7e: the data-parallel mesh (protein_clip_tpu_torch/parallel)
# ---------------------------------------------------------------------------

# (a) one step of each through the MeshEngine in an NCCL world of one rank,
# against the single-device engine's step on the same device batch
DP_WORLD1_STEPS = (("clip", "frozen", False), ("clip", "frozen", True),
                   ("clip", "finetune", True), ("clip", "lora", True),
                   ("filip", "frozen", True), ("filip", "finetune", True))
DP_PAIRS = {"clip": 64, "filip": 32}
# (b) two gloo ranks sharing the card, each with its half of the global batch
DP_GLOO_STEPS = (("clip", "frozen", True), ("filip", "frozen", False),
                 ("clip", "finetune", True))
DP_GLOO_LOCAL = 16
# The mesh steps at world size 1 run the single-device steps' launches in
# the same order and equal them to the bit. Two ranks against one device (b) run in f32 (--esm-dtype float32: K1-f32,
# K5-f32, TF32 off): the same rows through the backbone, the pooled sums, the
# loss and the ranks' gradients added in other orders: the loss within
# DP_GLOO_TOL relative, each gradient within DP_GLOO_TOL of its leaf's
# largest (the f32 finetune step's leaves within F32_FT_TOL, as phase 8's f32
# finetune check holds them).
DP_GLOO_TOL = 1e-5
DP_ENGINES = {("clip", "frozen"): clip_engine, ("clip", "finetune"): finetune,
              ("clip", "lora"): lora, ("filip", "frozen"): filip_engine,
              ("filip", "finetune"): filip_finetune}
DP_KERNELS = {("clip", "frozen"): ("attention_fwd", "infonce"),
              ("clip", "finetune"): ("attention_fwd", "attention_bwd", "infonce"),
              ("clip", "lora"): ("attention_fwd", "attention_bwd", "infonce"),
              ("filip", "frozen"): ("attention_fwd", "filip_maxsim"),
              ("filip", "finetune"): ("attention_fwd", "attention_bwd", "filip_maxsim")}


def dp_setup(arch: str, mode: str, n: int, dtype_name: str = "bfloat16"):
    """(engine config, trainable params, esm slot, peps, recs) of a mesh
    check: t30_150M with the train runs' seeded weights, CLIP or FILIP heads
    (seed SEED, dropout 0), LoRA adapters of rank LORA_RANK, and the first n
    training pairs of the 3000-family fixture; global batch n."""
    cfg_esm = common.esm_config("t30_150M", dtype_name)
    kind = filip.FILIPConfig if arch == "filip" else clip.CLIPConfig
    mcfg = kind(input_dim=cfg_esm.hidden_size, dropout=0.0, esm=cfg_esm)
    esm_params = esm2.init_params(cfg_esm, torch.Generator(device="cuda").manual_seed(0),
                                  dtype=cfg_esm.compute_dtype, device="cuda")
    heads0 = (filip if arch == "filip" else clip).init_params(
        mcfg, torch.Generator().manual_seed(SEED), device="cuda")
    peps, recs = fixture_pairs(n)
    cfg = clip_engine.EngineConfig(model=mcfg, batch_size=n, accumulated_batches=1,
                                   num_chunks=2, length_groups=1, packed=False)
    if mode == "finetune":
        return cfg, finetune.init_params(esm_params, heads0), {}, peps, recs
    if mode == "lora":
        adapters = lora.init_lora(torch.Generator(device="cuda").manual_seed(SEED + 1),
                                  esm_params, LORA_RANK)
        return cfg, lora.init_params(adapters, heads0), esm_params, peps, recs
    return cfg, heads0, esm_params, peps, recs


def dp_step(step, params, esm, batch) -> dict:
    """One step from ``params`` (Adam lr TRAIN_LR), the launch counts set
    to 0 just before and read just after: loss, gradients by leaf (as the
    optimizer took them: averaged over the ranks), updated params, launches,
    seconds and the step's peak memory above what was allocated before it
    (GB: activations, gradients, Adam state, the mesh's gradient buckets)."""
    state = capturing(optimizer.adam(TRAIN_LR).init(params), params)
    gc.collect()   # earlier garbage freed inside the step would hide its peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    _, _, loss = step(params, state, esm, batch, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    return {"loss": float(loss), "grads": state.grads, "seconds": took,
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "launches": {k: v for k, v in counts().items() if v},
            "params": {k: t.detach() for k, t in checkpoint._flatten(params).items()}}


def time_pmean(grads: dict) -> dict:
    """pmean_grads alone on a step's gradients (clones on leaves of their
    shapes), three calls: the gradients' MB, the fastest call's ms and the
    memory the call adds at its peak (MB)."""
    from protein_clip_tpu_torch.parallel.distributed import pmean_grads

    leaves = [torch.empty_like(g) for g in grads.values()]
    for t, g in zip(leaves, grads.values()):
        t.grad = g.clone()
    times, added = [], 0
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pmean_grads(leaves)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        added = max(added, torch.cuda.max_memory_allocated() - base)
    return {"grad_mb": sum(g.numel() * g.element_size() for g in grads.values()) / 1e6,
            "ms": 1e3 * min(times), "added_mb": added / 1e6}


def dp_gaps(got: dict, want: dict) -> dict:
    """Loss relative gap, the worst gradient gap over its leaf's largest,
    the largest updated-param gap and the entries past Adam's bound."""
    grad_gap, param_gap, over = 0.0, 0.0, 0
    for k, g in want["grads"].items():
        grad_gap = max(grad_gap, float((got["grads"][k] - g).abs().max())
                       / max(float(g.abs().max()), 1e-30))
        d = (got["params"][k] - want["params"][k]).abs()
        bound = 1e-6 + 2 * TRAIN_LR * (got["grads"][k] - g).abs() / (
            torch.maximum(got["grads"][k].abs(), g.abs()) + 1e-8)
        param_gap, over = max(param_gap, float(d.max())), over + int((d > bound).sum())
    return {"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grad_rel": grad_gap, "param_abs": param_gap, "over_adam_bound": over}


def dp_world1() -> dict:
    """(a): each DP_WORLD1_STEPS configuration, one step through the mesh
    engine in an NCCL world of one rank on the card and one through the
    single-device engine, from the same params and device batch (the mesh
    wire's: a shard of tokenize_packed_sharded is a flat packed batch):
    equal to the bit (loss, every gradient and updated leaf); the kernels
    of the path launch in the mesh step, as often as in the single-device
    one. Each step's peak memory beside the single-device step's, and
    pmean_grads timed alone on its gradients."""
    from protein_clip_tpu_torch.parallel import distributed
    from protein_clip_tpu_torch.parallel.engine import MeshEngine

    distributed.initialize(0, 1, f"tcp://127.0.0.1:{distributed.free_port()}", "nccl",
                           torch.device("cuda", 0))
    out, launches = {}, {}
    try:
        for arch, mode, packed in DP_WORLD1_STEPS:
            name = f"{arch}_{mode}{'_packed' if packed else ''}"
            cfg, params0, esm, peps, recs = dp_setup(arch, mode, DP_PAIRS[arch])
            cfg = dataclasses.replace(cfg, packed=packed)
            engine = MeshEngine(data=1, arch=arch, mode=mode, packed=packed)
            batch = to_device(engine.make_prepare(cfg, common.make_tokenizer())(peps, recs),
                              "cuda")
            one = dp_step(DP_ENGINES[arch, mode].make_train_step(cfg), clone_tree(params0), esm,
                          batch)
            mesh = dp_step(engine.make_train_step(cfg), clone_tree(params0), esm, batch)
            # the seconds and peaks of a second pair, mesh first: the first calls
            # warm both up
            again = dp_step(engine.make_train_step(cfg), clone_tree(params0), esm, batch)
            mesh_s, mesh_gb = again["seconds"], again["peak_gb"]
            again = dp_step(DP_ENGINES[arch, mode].make_train_step(cfg), clone_tree(params0), esm,
                            batch)
            one_s, one_gb = again["seconds"], again["peak_gb"]
            del again
            del params0
            for k, v in mesh["launches"].items():
                launches[k] = launches.get(k, 0) + v
            ran = kernel_counts(mesh["launches"])
            if (any(not ran.get(kernel) for kernel in DP_KERNELS[arch, mode])
                    or mesh["launches"] != one["launches"]):
                raise AssertionError(f"mesh step {name}: launches {ran}, the single-device "
                                     f"step's {kernel_counts(one['launches'])}")
            gaps = dp_gaps(mesh, one)
            ok = (mesh["loss"] == one["loss"] and mesh["grads"].keys() == one["grads"].keys()
                  and all(torch.equal(mesh["grads"][k], g) for k, g in one["grads"].items())
                  and all(torch.equal(mesh["params"][k], p) for k, p in one["params"].items()))
            pmean = time_pmean(mesh["grads"])
            log(f"[dp] world 1 (NCCL) {name} at {DP_PAIRS[arch]} pairs: loss {mesh['loss']:.6f} "
                f"vs one device {one['loss']:.6f}; gaps {gaps}; launches {ran}; step (second "
                f"call) {mesh_s:.3f} s vs one device {one_s:.3f} s; peak {mesh_gb:.4f} GB vs one "
                f"device {one_gb:.4f} GB (second calls); pmean_grads alone on "
                f"{pmean['grad_mb']:.1f} MB of gradients {pmean['ms']:.3f} ms, "
                f"+{pmean['added_mb']:.1f} MB at its peak {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"mesh step {name} at world size 1 disagrees with the "
                                     "single-device step")
            out[name] = {"loss": mesh["loss"], **gaps, "launches": ran, "ms": 1e3 * mesh_s,
                         "one_device_ms": 1e3 * one_s, "peak_gb": mesh_gb,
                         "one_device_peak_gb": one_gb, "pmean": pmean}
            del one, mesh
    finally:
        distributed.shutdown()
    return {"steps": out, "launches": launches}


def merged_shards(batch: dict) -> dict:
    """tokenize_packed_sharded's global wire as one flat packed batch of
    the same rows (shard-major) with its owners made global: the
    single-device step over the rows the ranks run."""
    out = {}
    for side in packed_engine.SIDES:
        operm = batch[f"{side}_operm"]
        offsets = torch.arange(operm.shape[0], dtype=operm.dtype)[:, None] * operm.shape[1]
        out[f"{side}_ids"] = batch[f"{side}_ids"]
        out[f"{side}_operm"] = (operm + offsets).reshape(-1)
    return out


def dp_gloo_inputs(arch: str, mode: str, packed: bool, n_ranks: int):
    """(engine config, params, esm slot, peps, recs) of a two-rank check:
    f32 t30_150M, global batch n_ranks * DP_GLOO_LOCAL, chunks of
    DP_GLOO_LOCAL rows (the padded FILIP step: one forward a rank, the same
    rows as one device's two chunks)."""
    cfg, params, esm, peps, recs = dp_setup(arch, mode, n_ranks * DP_GLOO_LOCAL, "float32")
    return dataclasses.replace(cfg, packed=packed, num_chunks=n_ranks), params, esm, peps, recs


def dp_gloo_rank(local_rank: int, out_path: str) -> None:
    """A rank of (b): every DP_GLOO_STEPS step through the mesh engine on
    its part of the batch; writes rank <r>.pt (loss, gradients, launches)."""
    from protein_clip_tpu_torch.parallel import distributed
    from protein_clip_tpu_torch.parallel.engine import MeshEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for arch, mode, packed in DP_GLOO_STEPS:
        cfg, params, esm, peps, recs = dp_gloo_inputs(arch, mode, packed,
                                                      distributed.world_size())
        engine = MeshEngine(data=distributed.world_size(), arch=arch, mode=mode, packed=packed)
        batch = to_device(engine.make_prepare(cfg, common.make_tokenizer())(peps, recs), "cuda")
        r = dp_step(engine.make_train_step(cfg), params, esm, batch)
        out[f"{arch}_{mode}{'_packed' if packed else ''}"] = {
            "loss": r["loss"], "grads": {k: g.cpu() for k, g in r["grads"].items()},
            "launches": r["launches"], "seconds": r["seconds"]}
        del params, r
    torch.save(out, Path(out_path) / f"rank{distributed.rank()}.pt")


def dp_gloo() -> dict:
    """(b): DP_GLOO_STEPS on two gloo ranks that share the card (spawned
    once the kernels are built: they load this process's builds), each
    against the single-device step on the card over the same global batch
    (packed: the ranks' rows as one batch), DP_GLOO_TOL; both ranks' losses
    and gradients equal to the bit. gloo takes CUDA tensors for every
    collective the steps use on torch 2.11 (all_gather_into_tensor,
    reduce_scatter_tensor, all_reduce, broadcast_object_list, barrier)."""
    from protein_clip_tpu_torch.parallel import distributed, packed_step

    work = WORK / "dp_gloo"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    distributed.spawn(dp_gloo_rank, (str(work),), 2, world=2,
                      init_method=f"tcp://127.0.0.1:{distributed.free_port()}", backend="gloo",
                      device_type="cuda", cards=[0, 0])
    spawned = time.perf_counter() - t0
    ranks = [torch.load(work / f"rank{r}.pt") for r in range(2)]
    out, launches = {}, {}
    for arch, mode, packed in DP_GLOO_STEPS:
        name = f"{arch}_{mode}{'_packed' if packed else ''}"
        r0, r1 = ranks[0][name], ranks[1][name]
        if r0["loss"] != r1["loss"] or any(not torch.equal(g, r1["grads"][k])
                                           for k, g in r0["grads"].items()):
            raise AssertionError(f"two-rank {name}: the ranks' losses or gradients differ")
        cfg, params, esm, peps, recs = dp_gloo_inputs(arch, mode, packed, 2)
        tok = common.make_tokenizer()
        batch = (merged_shards(packed_step.tokenize_packed_sharded(tok, peps, recs, 2)) if packed
                 else clip_engine.tokenize_pair_batch(tok, peps, recs))
        one = dp_step(DP_ENGINES[arch, mode].make_train_step(cfg), params, esm,
                      to_device(batch, "cuda"))
        del params
        got = {"loss": r0["loss"], "grads": {k: g.cuda() for k, g in r0["grads"].items()}}
        loss_rel = abs(got["loss"] - one["loss"]) / abs(one["loss"])
        worst = {k: float((got["grads"][k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                 for k, g in one["grads"].items()}
        tol = {k: F32_FT_TOL if mode == "finetune" and k.startswith("esm/") else DP_GLOO_TOL
               for k in worst}
        both = {k: r0["launches"].get(k, 0) + r1["launches"].get(k, 0)
                for k in set(r0["launches"]) | set(r1["launches"])}
        for k, v in both.items():
            launches[k] = launches.get(k, 0) + v
        ok = loss_rel <= DP_GLOO_TOL and all(worst[k] <= tol[k] for k in worst)
        top = max(worst, key=worst.get)
        log(f"[dp] two gloo ranks on one card, {name} f32 at {2 * DP_GLOO_LOCAL} pairs: loss "
            f"{got['loss']:.7f} vs one device {one['loss']:.7f} (relative {loss_rel:.3g}, "
            f"tolerance {DP_GLOO_TOL:g}); worst gradient {top} {worst[top]:.3g} of its leaf's "
            f"largest (tolerance {tol[top]:.3g}); launches of both ranks {kernel_counts(both)}; "
            f"rank 0's step {r0['seconds']:.3f} s, one device's {one['seconds']:.3f} s (two "
            f"ranks on one card through the host: no rate) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"two-rank {name} disagrees with the single-device step")
        out[name] = {"loss_rel": loss_rel, "grad_rel": worst[top],
                     "launches": kernel_counts(both), "rank0_ms": 1e3 * r0["seconds"],
                     "one_device_ms": 1e3 * one["seconds"]}
        del one
    log(f"[timing] two-rank spawn and steps: {spawned:.1f} s")
    return {"steps": out, "launches": launches}


def dp_refusal() -> dict:
    """(c): cli.main_2protein --dp 2 on this one-card machine exits nonzero
    before anything loads, naming the card count."""
    data, runs = WORK / "dp_refusal_data", WORK / "dp_refusal_runs"
    proc = subprocess.run(
        [sys.executable, "-m", "protein_clip_tpu_torch.cli.main_2protein", "--esm-config",
         "tiny", "--synthetic-fixture", "--data-dir", str(data), "--fixture-families", "40",
         "--batch-size", "4", "--accumulated-batches", "2", "--epochs", "1", "--runs-dir",
         str(runs), "--dp", "2"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    visible = torch.cuda.device_count()
    if proc.returncode == 0 or f"{visible} visible" not in proc.stderr or runs.exists():
        raise AssertionError(f"cli.main_2protein --dp 2 on {visible} card(s): exit "
                             f"{proc.returncode}, {proc.stderr[-2000:]}")
    message = proc.stderr.strip().splitlines()[-1]
    log(f"[dp] cli.main_2protein --dp 2 on {visible} card: exit {proc.returncode}: {message}")
    return {"exit": proc.returncode, "message": message}


def run_dp_phase() -> dict:
    """Phase 7e: the mesh at world size 1 under NCCL (a), two gloo ranks on
    the one card (b), the one-card refusal (c)."""
    world1 = timed("dp world 1 (NCCL)", dp_world1)
    gloo = timed("dp two gloo ranks", dp_gloo)
    refusal = timed("dp refusal", dp_refusal)
    return {"world1": world1, "gloo": gloo, "refusal": refusal}


# ---------------------------------------------------------------------------
# Phase 7f: tensor parallelism, the 'model' mesh axis (protein_clip_tpu_torch/
# parallel/sharding.py, the sharded forward of models/esm2.py)
# ---------------------------------------------------------------------------

# (a) the forward at tp = 2 against one device: TP_FWD_SEQS receptors of the
# fixture, t30_150M. Each hidden state's error is read as rms(tp - one) /
# rms(one) over the valid tokens; the pooled embeddings (masked means) by
# their cosine. bf16 (and gated K6, bf16): the row linears' partial products
# go through P1 and are summed in f32 and rounded once, where one device's
# bf16 matmul rounds its own f32 sum once: bf16 roundings that flip, carried
# through 30 layers. The first reading, 0.0135 (2^-7 was predicted, from
# the tiny backbone's 4.9e-4 on the CPU), is the order of those sums: one
# device whose o and wo go through P1 whole reads 0 (the same roundings),
# one whose o and wo sum two halves through P1 in f32 (the bf16 witness,
# printed) reads the split's own distance. TP_BF16_TOL is 2^-5, which the
# planted fault (both ranks skip the all-reduce after o, each keeping its
# partial; 1.04) must exceed TP_FAULT_MARGIN times; pooled cosines >=
# TP_COS_MIN. f32: the row
# partials summed in another order: TP_F32_TOL. int8: exact s32 sums, to
# the bit.
TP_FWD_SEQS = 16
TP_BF16_TOL = 2 ** -5
TP_F32_TOL = 1e-5
TP_COS_MIN = 0.9999
TP_FAULT_MARGIN = 10
# (b) one step each at tp = 2 on two gloo ranks sharing the card, f32,
# TP_PAIRS pairs (MLM: TP_PAIRS receptors), against the one-device step on
# the same batch: the loss within DP_GLOO_TOL relative, every gradient within
# DP_GLOO_TOL of its leaf's largest (F32_FT_TOL for the finetuned backbone's
# leaves, as phase 7e holds them); both ranks' losses and gradients equal to
# the bit (the split leaves gathered over the model group). FILIP's heads
# are held within TP_FILIP_TOL of the step's largest gradient entry, a limit
# set after the first reading: the backbone's f32 hidden states at tp = 2
# sit ~1e-6 from one device's (the row sums' order), which flips near-tied
# max-sim tokens, whose cotangent then lands on another token's row (2.39e-4
# of rec/aa_ffn/out/b's largest entry on the card, 2.0e-5 of the step's on
# the tiny CPU backbone; the loss equal). The planted fault (both ranks skip
# the all-reduce after o) must exceed TP_FAULT_MARGIN times it.
TP_PAIRS = 16
TP_FILIP_TOL = 2 ** -10
TP_STEPS = (("clip", "frozen"), ("clip", "finetune"), ("filip", "frozen"),
            ("mlm", "head"), ("mlm", "finetune"))
TP_KERNELS = {("clip", "frozen"): ("attention_fwd_f32", "infonce"),
              ("clip", "finetune"): ("attention_fwd_f32", "attention_bwd_f32", "infonce"),
              ("filip", "frozen"): ("attention_fwd_f32", "filip_maxsim"),
              ("mlm", "head"): ("attention_fwd_f32",),
              ("mlm", "finetune"): ("attention_fwd_f32", "attention_bwd_f32")}
# (c) MLM's mesh in an NCCL world of one rank (bf16, equal to the one-device
# steps to the bit) and its head step on two gloo ranks at dp = 2 (f32)
TP_MLM_WORLD1 = (("head", False), ("head", True), ("finetune", False))


def tp_fwd_batch() -> tuple:
    """(ids, mask) of TP_FWD_SEQS fixture receptors, on the card."""
    _, recs = fixture_pairs(16)
    enc = common.make_tokenizer()(recs[:TP_FWD_SEQS])
    return (torch.from_numpy(enc["input_ids"]).cuda(),
            torch.from_numpy(enc["attention_mask"]).cuda())


def tp_backbone(kind: str) -> tuple:
    """(config, params) of a forward check: t30_150M from the train runs'
    seed, bf16, f32, int8 (w8a8 over the bf16 tree) or bf16 under the K6
    gate."""
    dtype = "float32" if kind == "f32" else "bfloat16"
    cfg = common.esm_config("t30_150M", "int8" if kind == "int8" else dtype)
    params = esm2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                              dtype=cfg.compute_dtype, device="cuda")
    return cfg, (esm2.quantize_params(params) if kind == "int8" else params)


def pooled(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask[..., None].float()
    return (hidden.float() * m).sum(1) / m.sum(1)


@contextlib.contextmanager
def skip_o_reduce():
    """The planted fault: every rank skips the all-reduce after the
    attention's o (the row linears alternate o, wo in each layer), each
    keeping its own partial product; wo's stay, so the ranks' collectives
    still pair."""
    from protein_clip_tpu_torch.parallel import distributed as dist_mod

    plain, calls = dist_mod.reduce_from_model, [0]

    def faulty(x, axis):
        calls[0] += 1
        return x if calls[0] % 2 == 1 else plain(x, axis)

    dist_mod.reduce_from_model = faulty
    try:
        yield
    finally:
        dist_mod.reduce_from_model = plain


def tp_forward_rank(mesh) -> dict:
    """A rank's forwards of (a) on its slices: the hidden states (valid
    tokens' rows, f32 on the host), each path's launches, and the bytes of
    its sharded backbone against the whole one."""
    from protein_clip_tpu_torch.parallel import sharding
    from protein_clip_tpu_torch.parallel.step import tp_model_config

    ids, mask = tp_fwd_batch()
    out = {}
    for kind in ("bf16", "f32", "int8", "k6", "fault"):
        cfg, full = tp_backbone("bf16" if kind in ("k6", "fault") else kind)
        shards = sharding.shard_params(mesh, full)
        nbytes = (sharding.nbytes(shards), sharding.nbytes(full))
        del full
        gate = ffn_gate() if kind == "k6" else contextlib.nullcontext()
        fault = skip_o_reduce() if kind == "fault" else contextlib.nullcontext()
        reset_counts()
        with gate, fault, torch.no_grad():
            hidden = esm2.forward(shards, ids, mask, tp_model_config(cfg, mesh))
        torch.cuda.synchronize()
        out[kind] = {"hidden": hidden.float().cpu(), "launches": kernel_counts(counts()),
                     "bytes": nbytes[0], "full_bytes": nbytes[1],
                     "heads": shards["layers"]["attn"]["q"]["w" if kind != "int8" else "w_q"]
                     .shape[-1] // cfg.head_dim}
        del shards, hidden
    return out


def tp_mlm_setup(mode: str, n: int, dtype_name: str = "float32") -> tuple:
    """(config, trainable, esm slot, view, host arrays, masks) of an MLM
    check: t30_150M (seed 0) with the run's head (seed 42), the receptors of
    the first n fixture pairs, masks at 0.15 from a seeded CPU generator
    (the same in every process)."""
    cfg = common.esm_config("t30_150M", dtype_name)
    esm_params = esm2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  dtype=cfg.compute_dtype, device="cuda")
    head = esm2.init_lm_head(cfg, torch.Generator().manual_seed(42), device="cuda")
    _, recs = fixture_pairs(16)
    enc = common.make_tokenizer()(recs[:n])
    arrs = (torch.from_numpy(enc["input_ids"]), torch.from_numpy(enc["attention_mask"]))
    host = mlm_train.batch_inputs(arrs, False)
    masks = mlm_train.draw_masks(torch.Generator().manual_seed(SEED), host, 0.15)
    return cfg, head, esm_params, arrs, masks


def tp_mlm_trainable(mode: str, cfg, head: dict, esm_params: dict) -> tuple:
    args = argparse.Namespace(seed=42, lora_rank=0, lora_ffn=False)
    trainable, view, _ = mlm_train.trainable_tree(args, mode, head, esm_params, cfg, "cuda")
    return trainable, ({} if mode == "finetune" else esm_params), view


def tp_mlm_step(mode: str, mesh, rows: slice | None = None, dtype_name: str = "float32") -> dict:
    """One MLM step of ``mode`` (Adam lr TRAIN_LR) on ``mesh``'s rank (None:
    one device): the rank's rows of the batch (``rows`` of its masks), its
    loss, gradients (split leaves gathered), launches."""
    from protein_clip_tpu_torch.parallel import mlm_step as mesh_mlm, sharding
    from protein_clip_tpu_torch.parallel.step import tp_model_config
    from protein_clip_tpu_torch.train.mlm_engine import make_steps

    cfg, head, esm_params, arrs, masks = tp_mlm_setup(mode, TP_PAIRS, dtype_name)
    step_cfg = cfg if mesh is None else tp_model_config(cfg, mesh)
    trainable, esm_slot, view = tp_mlm_trainable(mode, step_cfg, head, esm_params)
    if mesh is not None:
        trainable = sharding.shard_params(mesh, trainable)
        esm_slot = sharding.shard_params(mesh, esm_slot)
        arrs = mesh_mlm.rank_rows(arrs, mesh)
        masks = tuple(m[rows] for m in masks) if rows is not None else masks
        step, _ = mesh_mlm.make_sharded_mlm_steps(cfg, mesh, mode, view)
    else:
        step, _ = make_steps(cfg, mode, view)
    inputs = mlm_train.batch_inputs(to_device(arrs, "cuda"), False)
    state = capturing(optimizer.adam(TRAIN_LR).init(trainable), trainable)
    reset_counts()
    _, _, loss = step(trainable, state, esm_slot, inputs, to_device(masks, "cuda"))
    torch.cuda.synchronize()
    grads = state.grads
    if mesh is not None and mesh.model > 1:
        grads = sharding.gather_params(mesh, grads)
    return {"loss": float(loss), "grads": {k: g.cpu() for k, g in grads.items()},
            "launches": kernel_counts(counts())}


def tp_clip_step(arch: str, mode: str, mesh) -> dict:
    """One CLIP or FILIP step of ``mode`` (f32, Adam lr TRAIN_LR) through the
    MeshEngine on ``mesh`` (None: the single-device engine) over TP_PAIRS
    pairs: loss, gradients in the one-device layout, launches."""
    from protein_clip_tpu_torch.parallel import sharding
    from protein_clip_tpu_torch.parallel.engine import MeshEngine

    cfg, params, esm, peps, recs = dp_gloo_inputs(arch, mode, False, 1)
    tok = common.make_tokenizer()
    if mesh is None:
        step = DP_ENGINES[arch, mode].make_train_step(cfg)
        batch = clip_engine.tokenize_pair_batch(tok, peps, recs)
    else:
        engine = MeshEngine(data=mesh.data, model=mesh.model, arch=arch, mode=mode,
                            esm=cfg.model.esm)
        params, esm = engine.prepare_params(params), engine.prepare_esm(esm)
        step = engine.make_train_step(cfg)
        batch = engine.make_prepare(cfg, tok)(peps, recs)
    r = dp_step(step, params, esm, to_device(batch, "cuda"))
    grads = r["grads"]
    if mesh is not None and mesh.model > 1:
        grads = sharding.gather_params(mesh, grads)
    return {"loss": r["loss"], "grads": {k: g.cpu() for k, g in grads.items()},
            "launches": kernel_counts(r["launches"]), "seconds": r["seconds"]}


def tp_gloo_rank(local_rank: int, out_path: str) -> None:
    """A rank of the two-rank world: (a) the forwards and (b) the steps on
    a (1, 2) mesh, (c) the MLM head step on a (2, 1) one; writes rank
    <r>.pt."""
    from protein_clip_tpu_torch.parallel import distributed
    from protein_clip_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp = make_mesh(data=1, model=2, esm_cfg=esm2.ESM2Config.t30_150M())
    out = {"forwards": tp_forward_rank(tp), "steps": {}}
    for arch, mode in TP_STEPS:
        t0 = time.perf_counter()
        out["steps"][f"{arch}_{mode}"] = (tp_mlm_step(mode, tp) if arch == "mlm"
                                          else tp_clip_step(arch, mode, tp))
        out["steps"][f"{arch}_{mode}"]["rank_seconds"] = time.perf_counter() - t0
    with skip_o_reduce():
        out["filip_fault"] = tp_clip_step("filip", "frozen", tp)
    dp2 = make_mesh(data=2, model=1)
    b = TP_PAIRS // 2
    out["mlm_dp2"] = tp_mlm_step("head", dp2, slice(dp2.index * b, (dp2.index + 1) * b))
    torch.save(out, Path(out_path) / f"rank{distributed.rank()}.pt")


@contextlib.contextmanager
def split_row_linears(cfg):
    """One device's forward with its o and wo summed from two halves of
    their input through P1 in f32, rounded once: the arithmetic of the
    row linears at tp = 2 with no ranks, the bf16 witness of (a). Yields
    the config to run."""
    from protein_clip_tpu_torch.parallel import distributed as dist_mod

    def split(x, w):
        k = x.shape[1] // 2
        return sum(dense_mm.mm(x[:, i:i + k].contiguous(), w[i:i + k].contiguous(),
                               torch.float32) for i in (0, k))

    plain, partial = dist_mod.reduce_from_model, esm2._PartialMM.apply
    dist_mod.reduce_from_model, esm2._PartialMM.apply = (lambda x, axis: x), split
    try:
        yield dataclasses.replace(cfg, model_axis=dist_mod.ModelAxis(1, 0))
    finally:
        dist_mod.reduce_from_model, esm2._PartialMM.apply = plain, partial


def rel_rms(got: torch.Tensor, want: torch.Tensor, mask: torch.Tensor) -> float:
    valid = mask.bool().cpu()
    d = (got - want)[valid]
    return float(d.square().mean().sqrt() / want[valid].square().mean().sqrt())


def tp_forward_checks(ranks: list[dict]) -> dict:
    """(a) against the one-device forwards of this process."""
    ids, mask = tp_fwd_batch()
    out = {}
    for kind in ("bf16", "f32", "int8", "k6"):
        cfg, full = tp_backbone(kind)
        gate = ffn_gate() if kind == "k6" else contextlib.nullcontext()
        with gate, torch.no_grad():
            one = esm2.forward(full, ids, mask, cfg).float().cpu()
        if kind == "bf16":
            with split_row_linears(cfg) as wcfg, torch.no_grad():
                witness = esm2.forward(full, ids, mask, wcfg).float().cpu()
            out["bf16_witness_rel_rms"] = rel_rms(witness, one, mask)
            del witness
        r0, r1 = ranks[0]["forwards"][kind], ranks[1]["forwards"][kind]
        same = torch.equal(r0["hidden"], r1["hidden"])
        err = rel_rms(r0["hidden"], one, mask)
        cos = float(torch.nn.functional.cosine_similarity(
            pooled(r0["hidden"], mask.cpu()), pooled(one, mask.cpu()), dim=-1).min())
        out[kind] = {"rel_rms": err, "cos_min": cos, "ranks_equal": same,
                     "launches": r0["launches"], "heads": r0["heads"],
                     "rank_bytes": r0["bytes"], "one_device_bytes": r0["full_bytes"]}
        if kind == "bf16":
            out["fault_rel_rms"] = rel_rms(ranks[0]["forwards"]["fault"]["hidden"], one, mask)
        del full
    tol = {"bf16": TP_BF16_TOL, "k6": TP_BF16_TOL, "f32": TP_F32_TOL, "int8": 0.0}
    want = {"bf16": {"attention_fwd": 30, "dense_mm": 60}, "f32": {"attention_fwd_f32": 30},
            "int8": {"attention_fwd": 30, "dense_mm": 180},
            "k6": {"attention_fwd": 30, "ffn_gelu": 30, "dense_mm": 60}}
    ok = out["fault_rel_rms"] > TP_FAULT_MARGIN * TP_BF16_TOL
    for kind, row in out.items():
        if not isinstance(row, dict):
            continue
        good = (row["ranks_equal"] and row["rel_rms"] <= tol[kind] and row["launches"] == want[kind]
                and row["heads"] == 10 and (kind == "int8" and row["rel_rms"] == 0.0
                                            or kind != "int8" and row["cos_min"] >= TP_COS_MIN))
        ok = ok and good
        log(f"[tp] forward at tp = 2 vs one device, {kind}, {tuple(ids.shape)}: rms(tp - one) / "
            f"rms(one) {row['rel_rms']:.3g} (tolerance {tol[kind]:g}{', to the bit' if kind == 'int8' else ''}), "
            f"pooled cosine min {row['cos_min']:.7f} (>= {TP_COS_MIN}); ranks equal {row['ranks_equal']}; "
            f"a rank's launches {row['launches']} on {row['heads']} heads (want {want[kind]}); "
            f"its backbone {row['rank_bytes'] / 1e6:.1f} MB of the one device's "
            f"{row['one_device_bytes'] / 1e6:.1f} MB {'ok' if good else 'FAIL'}")
    log(f"[tp] bf16 witness (one device, o and wo summed from two halves through P1 in f32): "
        f"rms(witness - "
        f"one) / rms(one) {out['bf16_witness_rel_rms']:.3g}; planted fault (the all-reduce after "
        f"o skipped): {out['fault_rel_rms']:.3g}, must pass {TP_FAULT_MARGIN} x "
        f"{TP_BF16_TOL:g}")
    if not ok:
        raise AssertionError("the forward at tp = 2 disagrees with one device")
    return out


def tp_step_gaps(got: dict, one: dict, finetune: bool, filip: bool) -> tuple[float, dict]:
    """(loss gap, each leaf's gradient gap over its scale, each leaf's
    tolerance): the scale is the leaf's largest entry, FILIP's the step's."""
    loss_rel = abs(got["loss"] - one["loss"]) / abs(one["loss"])
    step_max = max(float(g.abs().max()) for g in one["grads"].values())
    worst = {k: float((got["grads"][k] - g).abs().max())
             / max(step_max if filip else float(g.abs().max()), 1e-30)
             for k, g in one["grads"].items()}
    tol = {k: F32_FT_TOL if finetune and k.startswith("esm/") else
           TP_FILIP_TOL if filip else DP_GLOO_TOL for k in worst}
    return loss_rel, worst, tol


def tp_step_checks(ranks: list[dict]) -> dict:
    """(b) and the gloo part of (c) against this process's one-device steps."""
    out, launches = {}, {}
    for arch, mode in TP_STEPS + (("mlm_dp2", "head"),):
        name = f"{arch}_{mode}" if arch != "mlm_dp2" else "mlm_dp2"
        r0, r1 = (r["steps"].get(name) or r[name] for r in ranks)
        same = r0["loss"] == r1["loss"] and all(torch.equal(g, r1["grads"][k])
                                                for k, g in r0["grads"].items())
        if arch in ("mlm", "mlm_dp2"):
            one = tp_mlm_step(mode, None)
        else:
            one = tp_clip_step(arch, mode, None)
        loss_rel, worst, tol = tp_step_gaps(r0, one, mode == "finetune", arch == "filip")
        fault = ""
        if arch == "filip":
            read = max(tp_step_gaps(ranks[0]["filip_fault"], one, False, True)[1].values())
            fault = f"; the planted fault {read:.3g}"
            ok_fault = read > TP_FAULT_MARGIN * TP_FILIP_TOL
        top = max(worst, key=worst.get)
        kernels = TP_KERNELS.get((arch if arch != "mlm_dp2" else "mlm", mode), ())
        ran = all(r0["launches"].get(k) for k in kernels)
        ok = same and ran and loss_rel <= DP_GLOO_TOL and all(worst[k] <= tol[k] for k in worst) \
            and r0["grads"].keys() == one["grads"].keys() and (arch != "filip" or ok_fault)
        for k, v in r0["launches"].items():
            launches[k] = launches.get(k, 0) + v + r1["launches"].get(k, 0)
        log(f"[tp] {name} f32 at {'dp = 2' if arch == 'mlm_dp2' else 'tp = 2'} on two gloo ranks, "
            f"{TP_PAIRS} {'receptors' if arch.startswith('mlm') else 'pairs'}: loss "
            f"{r0['loss']:.7f} vs one device {one['loss']:.7f} (relative {loss_rel:.3g}, "
            f"tolerance {DP_GLOO_TOL:g}); worst gradient {top} {worst[top]:.3g} of "
            f"{'the step' if arch == 'filip' else 'its leaf'}'s largest (tolerance "
            f"{tol[top]:.3g}{fault}); ranks equal to the bit {same}; a rank's "
            f"launches {r0['launches']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} on the mesh disagrees with the one-device step")
        out[name] = {"loss_rel": loss_rel, "grad_rel": worst[top], "launches": r0["launches"]}
    return {"steps": out, "launches": launches}


def tp_gloo() -> dict:
    """(a), (b) and (c)'s two-rank part: two gloo ranks spawned on the one
    card (they load this process's builds), checked here against one
    device. gloo's all-reduce MAX (f32) and SUM (int32) on CUDA tensors
    carry the int8 row linears: if gloo refuses them the phase fails."""
    from protein_clip_tpu_torch.parallel import distributed

    fixture_pairs(16)     # written here, before the ranks read it
    work = WORK / "tp_gloo"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    distributed.spawn(tp_gloo_rank, (str(work),), 2, world=2,
                      init_method=f"tcp://127.0.0.1:{distributed.free_port()}", backend="gloo",
                      device_type="cuda", cards=[0, 0])
    log(f"[timing] tp two gloo ranks, spawn and rank work: {time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(work / f"rank{r}.pt") for r in range(2)]
    forwards = timed("tp forward checks", tp_forward_checks, ranks)
    steps = timed("tp step checks", tp_step_checks, ranks)
    return {"forwards": forwards, **steps}


def tp_mlm_world1() -> dict:
    """(c): MLM's mesh steps in an NCCL world of one rank (bf16 t30_150M,
    TP_PAIRS receptors, fixed masks) against the one-device steps, equal to
    the bit (loss and every gradient), with the same launches."""
    from protein_clip_tpu_torch.parallel import distributed, mlm_step as mesh_mlm
    from protein_clip_tpu_torch.parallel.mesh import make_mesh
    from protein_clip_tpu_torch.train.mlm_engine import make_steps

    distributed.initialize(0, 1, f"tcp://127.0.0.1:{distributed.free_port()}", "nccl",
                           torch.device("cuda", 0))
    out = {}
    try:
        mesh = make_mesh()
        for mode, packed in TP_MLM_WORLD1:
            name = f"mlm_{mode}{'_packed' if packed else ''}"
            cfg, head, esm_params, arrs, _ = tp_mlm_setup(mode, TP_PAIRS, "bfloat16")
            if packed:
                _, recs = fixture_pairs(16)
                arrs = (packed_engine.tokenize_packed_rows_sharded(
                    common.make_tokenizer(), recs[:TP_PAIRS], 1),)
            inputs = mlm_train.batch_inputs(to_device(arrs, "cuda"), packed)
            masks = mlm_train.draw_masks(torch.Generator(device="cuda").manual_seed(SEED), inputs,
                                         0.15)
            got = {}
            for which, steps in (("mesh", mesh_mlm.make_sharded_mlm_steps), ("one", None)):
                trainable, esm_slot, view = tp_mlm_trainable(mode, cfg, clone_tree(head),
                                                             esm_params)
                step = (steps(cfg, mesh, mode, view)[0] if steps else
                        make_steps(cfg, mode, view)[0])
                state = capturing(optimizer.adam(TRAIN_LR).init(trainable), trainable)
                reset_counts()
                _, _, loss = step(trainable, state, esm_slot, inputs, masks)
                torch.cuda.synchronize()
                got[which] = {"loss": float(loss), "grads": state.grads,
                              "launches": kernel_counts(counts())}
            m, o = got["mesh"], got["one"]
            ok = (m["loss"] == o["loss"] and m["launches"] == o["launches"]
                  and m["launches"].get("attention_fwd")
                  and all(torch.equal(m["grads"][k], g) for k, g in o["grads"].items()))
            log(f"[tp] MLM mesh at world size 1 (NCCL) {name}, bf16, {TP_PAIRS} receptors: loss "
                f"{m['loss']:.6f} vs one device {o['loss']:.6f}; launches {m['launches']} vs "
                f"{o['launches']}; equal to the bit {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the MLM mesh step {name} at world size 1 disagrees")
            out[name] = {"loss": m["loss"], "launches": m["launches"]}
            del got, m, o
    finally:
        distributed.shutdown()
    return out


def tp_refusal() -> dict:
    """(e): cli.main_2protein --tp 2 on this one-card machine exits nonzero
    before anything loads, naming the card count."""
    data, runs = WORK / "tp_refusal_data", WORK / "tp_refusal_runs"
    proc = subprocess.run(
        [sys.executable, "-m", "protein_clip_tpu_torch.cli.main_2protein", "--esm-config",
         "tiny", "--synthetic-fixture", "--data-dir", str(data), "--fixture-families", "40",
         "--batch-size", "4", "--accumulated-batches", "2", "--epochs", "1", "--runs-dir",
         str(runs), "--tp", "2"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    visible = torch.cuda.device_count()
    if proc.returncode == 0 or f"{visible} visible" not in proc.stderr or runs.exists():
        raise AssertionError(f"cli.main_2protein --tp 2 on {visible} card(s): exit "
                             f"{proc.returncode}, {proc.stderr[-2000:]}")
    message = proc.stderr.strip().splitlines()[-1]
    log(f"[tp] cli.main_2protein --tp 2 on {visible} card: exit {proc.returncode}: {message}")
    return {"exit": proc.returncode, "message": message}


def run_tp_phase() -> dict:
    """Phase 7f: the forward and the steps at tp = 2 on two gloo ranks (a,
    b, d), MLM's mesh (c), the one-card refusal (e)."""
    gloo = timed("tp two gloo ranks", tp_gloo)
    world1 = timed("tp MLM world 1 (NCCL)", tp_mlm_world1)
    refusal = timed("tp refusal", tp_refusal)
    return {"gloo": gloo, "mlm_world1": world1, "refusal": refusal}


def stop(server_ctx: dict) -> None:
    server_ctx["server"].shutdown()
    server_ctx["server"].server_close()
    server_ctx["thread"].join(timeout=60)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is visible", file=sys.stderr)
        return 1
    # the plain versions' f32 products run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    seconds: dict[str, float] = {}
    mark = [t_start]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = now - mark[0]
        mark[0] = now
        log(f"[timing] phase {name}: {seconds[name]:.1f} s ({now - t_start:.1f} s in all)")

    gpu = gpu_line()
    log(f"[build] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()

    def timed_build(name: str) -> tuple[str, float]:
        start = time.perf_counter()
        return build.build(name), time.perf_counter() - start

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        faults = pool.submit(build_faults)
        reports = list(pool.map(timed_build, KERNELS))
        fault_libs = faults.result()
    for name, (report, took) in zip(KERNELS, reports):
        log(f"[build] {name}: nvcc {took:.1f} s (all builds at once), "
            f"{build.library_path(name)}\n{report.strip()}")
    log(f"[build] done in {time.perf_counter() - t0:.1f} s (and the planted-fault copies "
        f"{', '.join(f'{k}: {sorted(v)}' for k, v in fault_libs.items())} under {FAULT_DIR})")
    phase_done("build")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    segments, t33_segments = path_segments(), path_segments(T33)
    k1_cases = attention_cases(gen, segments, t33_segments)
    max_err = check_attention(k1_cases)
    k4_cases = maxsim_cases(gen)
    k4_err = check_maxsim(k4_cases)
    nce_cases = infonce_cases(gen)
    nce_err = check_infonce(nce_cases)
    k5_cases = bwd_cases(gen, segments, t33_segments)
    k5_err = check_attention_bwd(k5_cases)
    f32_k1_cases = attention_cases_f32(gen, segments)
    f32_k1_err = check_attention(f32_k1_cases, "attention_fwd_f32")
    f32_k5_cases = bwd_cases_f32(gen, segments)
    f32_k5_err = check_attention_bwd(f32_k5_cases, "attention_bwd_f32")
    p1_err = check_dense_mm(gen)
    k6_err = check_ffn(gen)
    k6_f32_cases = ffn_f32_cases()
    k6_f32_err = check_ffn_f32(k6_f32_cases)
    fault_reads = check_faults(fault_libs["main_loop"], gen)
    fault_reads.update(check_ffn_f32_fault(fault_libs, k6_f32_cases))
    fault_reads.update(check_attention_faults(fault_libs, k1_cases, k5_cases))
    fault_reads.update(check_attention_faults(fault_libs, f32_k1_cases, f32_k5_cases,
                                              torch.float32))
    fault_reads.update(check_maxsim_faults(fault_libs, k4_cases))
    fault_reads.update(check_infonce_faults(fault_libs, nce_cases))
    del k1_cases, k5_cases, k4_cases, nce_cases, f32_k1_cases, f32_k5_cases
    phase_done("kernels")
    plots.plot_embedding_cosine_similarities = count_figures(
        plots.plot_embedding_cosine_similarities)
    rng = np.random.default_rng(SEED)
    ctx = run_serve_phase(rng)
    try:
        check_end_to_end(ctx)
        fctx = run_filip_phase(ctx, rng)
        try:
            check_filip_end_to_end(ctx, fctx)
            phase_done("serve, filip serve")
            t33ctx = run_t33_serve_phase(rng, gpu)
            families = run_families_phase()
            phase_done(f"{T33} serve, families")
            hctx = run_hf_phase(gpu)
            f32s = run_f32_serve_phase(ctx, hctx, rng, gpu)
            f32k6 = run_f32_k6_serve_phase(hctx, f32s, rng, gpu)
            hctx.pop("esm_params")
            phase_done("hf, f32 serve, f32 K6 serve")
            tctx = timed("run_train_phase", run_train_phase)
            pctx = timed("run_packed_phase", run_packed_phase)
            uctx = timed("run_packed_unfrozen_phase", run_packed_unfrozen_phase)
            phase_done("train, packed, packed unfrozen")
            t33train = run_t33_train_phase(fault_libs)
            phase_done(f"{T33} train")
            f32train = run_f32_train_phase(fault_libs)
            phase_done("f32 train")
            ftctx = timed("run_filip_train_phase", run_filip_train_phase, fault_libs, gen)
            fmctx = timed("run_filip_more_phase", run_filip_more_phase, fault_libs, gen)
            phase_done("filip train")
            rctx = run_resume_phase()
            ectx = run_eval_phase(tctx["k2"]["run"] / "best_model.npz",
                                  ftctx["runs"]["filip_10"]["run"] / "best_model.npz")
            phase_done("resume, eval")
            tiers = timed("run_tiers_phase", run_tiers_phase, fault_libs, gen)
            mlmctx = timed("run_mlm_phase", run_mlm_phase, fault_libs)
            phase_done("tiers, mlm")
            filip_dir = WORK / "filip_data"
            steps = {"k2": timed("check_step 256", check_step, 256),
                     "k3": timed("check_step 1024", check_step, 1024),
                     "packed": timed("check_step 256 packed", check_step, 256, packed=True),
                     "finetune": timed("check_finetune_step", check_finetune_step, fault_libs),
                     "finetune_packed": timed("check_finetune_step packed", check_finetune_step,
                                              fault_libs, packed=True),
                     "filip": timed("check_filip_step", check_filip_step, ftctx["runs"],
                                    filip_dir, fault_libs),
                     "filip_packed": timed("check_filip_packed_step", check_filip_packed_step,
                                           fmctx["runs"], filip_dir, fault_libs),
                     "filip_unfrozen": timed("check_filip_unfrozen_step",
                                             check_filip_unfrozen_step, fmctx["runs"], filip_dir,
                                             fault_libs)}
            phase_done("step checks")
            dpctx = timed("run_dp_phase", run_dp_phase)
            phase_done("dp")
            tpctx = timed("run_tp_phase", run_tp_phase)
            phase_done("tp")
            ictx = run_int8_serve_phase(ctx)
            try:
                i8train = run_int8_train()
                k6ctx = run_k6_serve_phase(ctx)
                phase_done("int8, K6 gate")
                times = timed("time_attention", time_attention, gen, gpu)
                k5_times = timed("time_attention_bwd", time_attention_bwd, gen, gpu, [
                    (kind, seg) for kind, path, seg in segments
                    if path and seg.shape in ((16, 256), (28, 2048))])
                family_times = timed("time_attention_families", time_attention_families, gen,
                                     gpu)
                f32_times = timed("time_attention_f32", time_attention_f32, gen, gpu)
                k4_times = timed("time_maxsim", time_maxsim, gen, gpu)
                nce_times = timed("time_infonce", time_infonce, gen, gpu)
                tier_times = timed("time_tier_chunks", time_tier_chunks, tiers["segments"], gen,
                                   gpu)
                dispatch = timed("time_dispatch", time_dispatch, gen, gpu)
                p1_times = timed("time_dense_mm", time_dense_mm, gen, gpu)
                k6_times = timed("time_ffn", time_ffn, gen, gpu)
                k6_f32_times = timed("time_ffn_f32", time_ffn_f32, 10240, 640, 2560, gpu)
                short_times = timed("time_short_products", time_short_products, gen, gpu)
                serving = {"bf16": timed("time_serving bf16", time_serving, ctx, rng, gpu),
                           "int8": timed("time_serving int8", time_serving, ictx, rng, gpu,
                                         "int8")}
                with ffn_gate():
                    serving["k6"] = timed("time_serving K6 gate", time_serving, ctx, rng, gpu,
                                          "PCT_FFN_PALLAS=1")
                timed("time_filip_serving", time_filip_serving, ctx, fctx, rng, gpu)
                filip_times = timed("time_filip_train", time_filip_train, ftctx, filip_dir, gpu)
                filip_more_times = timed("time_filip_more", time_filip_more, fmctx, filip_dir,
                                         gpu, ftctx["profile"])
                tctx["packed"] = pctx
                tctx["finetune_packed"], tctx["lora_packed"] = uctx["finetune"], uctx["lora"]
                pairs_per_s = {run: time_train_steps(tctx, run, what, gpu) for run, what in (
                    ("k2", "frozen train step (4 length groups)"),
                    ("packed", "packed frozen train step (flat packing)"),
                    ("finetune", "finetune step (one pad bucket, remat)"),
                    ("lora", f"LoRA step (rank {LORA_RANK}, one pad bucket, remat)"),
                    ("finetune_packed", "packed finetune step (flat packing, remat)"),
                    ("lora_packed", f"packed LoRA step (rank {LORA_RANK}, flat packing, "
                                    "remat)"))}
                pairs_per_s["int8"] = time_train_steps(
                    {"int8": i8train, "profile": f"{INT8_FIXTURE_FAMILIES} families"}, "int8",
                    "int8 w8a8 frozen train step (4 length groups)", gpu)
                pairs_per_s["f32_finetune_packed"] = time_train_steps(
                    f32train, "finetune_packed", "f32 packed finetune step (flat packing, remat)",
                    gpu)
                pairs_per_s["f32_k6_finetune_packed"] = time_train_steps(
                    f32train, "finetune_packed_k6",
                    "f32 packed finetune step under PCT_FFN_PALLAS=1 (K6-f32)", gpu)
                pairs_per_s["tiered"] = time_train_steps(
                    {"tiered": tiers["run"], "profile": f"long-tail, {LONGTAIL_PAIRS} pairs"},
                    "tiered", f"packed frozen train step in {PACK_TIERS} width tiers", gpu)
                pairs_per_s["filip_tiered"] = time_train_steps(
                    {"tiered": tiers["filip"], "profile": f"long-tail, {LONGTAIL_PAIRS} pairs"},
                    "tiered", f"packed FILIP step in {PACK_TIERS} width tiers", gpu, 128)
                pairs_per_s.update({f"{T33}_{run}": time_train_steps(t33train, run, what, gpu)
                                    for run, what in (
                    ("packed", "packed frozen train step (flat packing)"),
                    ("finetune_packed", "packed finetune step (flat packing, remat)"))})
                phase_done("times")
            finally:
                stop(ictx)
        finally:
            stop(fctx)
    finally:
        stop(ctx)
        shutil.rmtree(WORK, ignore_errors=True)
        shutil.rmtree(FAULT_DIR, ignore_errors=True)

    paths = {"serve": ctx["launches"], "filip_serve": fctx["launches"],
             "train_256": tctx["k2"]["launches"], "train_1024": tctx["k3"]["launches"],
             "train_packed": pctx["launches"],
             "train_finetune": tctx["finetune"]["launches"],
             "train_lora": tctx["lora"]["launches"],
             "train_finetune_packed": uctx["finetune"]["launches"],
             "train_lora_packed": uctx["lora"]["launches"],
             **{f"train_{name}": run["launches"] for name, run in ftctx["runs"].items()},
             **{f"train_{name}": run["launches"] for name, run in fmctx["runs"].items()},
             "int8_serve": ictx["launches"],
             "int8_train": i8train["launches"], "k6_serve": k6ctx["launches"],
             f"{T33}_serve": t33ctx["launches"],
             f"{T33}_train_packed": t33train["packed"]["launches"],
             f"{T33}_train_finetune_packed": t33train["finetune_packed"]["launches"],
             **{f"{name}_forwards": {"attention_fwd": sum(row[kind]["launches"]
                                                          for kind in ("padded", "packed"))}
                for name, row in families.items()},
             "f32_serve": f32s["launches"],
             "f32_train_finetune_packed": f32train["finetune_packed"]["launches"],
             "f32_train_frozen_step": {"attention_fwd_f32":
                                       f32train["frozen_step"]["attention_fwd_f32"]},
             "f32_k6_serve": f32k6["launches"],
             "f32_k6_train_finetune_packed": f32train["finetune_packed_k6"]["launches"],
             "f32_k6_train_frozen_step": {
                 "attention_fwd_f32": f32train["frozen_step"]["attention_fwd_f32"],
                 "ffn_gelu_f32": f32train["frozen_step"]["ffn_gelu_f32"]},
             **{name: run["launches"] for name, run in rctx.items()},
             "train_tiered": tiers["run"]["launches"],
             "train_filip_tiered": tiers["filip"]["launches"],
             **{name: run["launches"] for name, run in mlmctx["runs"].items()},
             **{name: kernel_counts(run["launches"]) for name, run in ectx.items()},
             "figures": kernel_counts(FIGURES["launches"]),
             "train_dp_world1": kernel_counts(dpctx["world1"]["launches"]),
             "train_dp_gloo2": kernel_counts(dpctx["gloo"]["launches"]),
             "train_tp2_gloo": tpctx["gloo"]["launches"],
             **{f"forward_tp2_{kind}": row["launches"]
                for kind, row in tpctx["gloo"]["forwards"].items() if isinstance(row, dict)},
             **{f"train_{name}_world1": row["launches"]
                for name, row in tpctx["mlm_world1"].items()}}
    by_path = {name: {path: counts.get(name, 0) for path, counts in paths.items()}
               for name in ("attention_fwd", "attention_bwd", *F32_KERNELS, "filip_maxsim",
                            "infonce", "infonce_tiled", "dense_mm", "ffn_gelu", "ffn_gelu_f32")}
    kernels = [{
        "name": "attention_fwd", "phase": "serve", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "protein_clip_tpu/ops/attention_pallas.py:105",
        "launches": ctx["launches"]["attention_fwd"],
        "launches_by_path": by_path["attention_fwd"], "max_abs_err": max_err, **times,
        "fault": {k: fault_reads[k] for k in ("attention_fwd_swept_tiles", "attention_fwd_skip")},
        "train_packed": {"launches": pctx["launches"]["attention_fwd"],
                         "chunk_forwards_per_step": pctx["chunks_per_step"],
                         "cos_min_vs_grouped": pctx["paths"]["cos_min"]},
        "train_finetune_packed": {"launches": uctx["finetune"]["launches"]["attention_fwd"],
                                  "chunk_forwards_per_pass": uctx["finetune"]["chunks_per_pass"]},
        "train_filip_more": {"path_chunks_max_abs_err": fmctx["chunks"]["attention_fwd"],
                             "path_chunk_shapes": fmctx["chunks"]["shapes"],
                             **{name: {"launches": run["launches"]["attention_fwd"],
                                       "chunk_forwards_per_step": run["chunks_per_step"]}
                                for name, run in fmctx["runs"].items()}},
        "head_dims": [{"shape": row["shape"], **row["attention_fwd"]} for row in family_times],
        "train_tiered": {"launches": tiers["run"]["launches"]["attention_fwd"],
                         "chunk_forwards_per_step": tiers["run"]["chunks_per_step"],
                         "layout": tiers["layout"], "flat_layout": tiers["flat_layout"],
                         "slots": tiers["slots"], "placeholder_packs": tiers["placeholder_packs"],
                         "path_chunks": tiers["chunks"], "chunk_times": tier_times,
                         "pairs_per_s": pairs_per_s["tiered"],
                         "filip_launches": tiers["filip"]["launches"]["attention_fwd"]},
        "mlm": {name: {"launches": run["launches"]["attention_fwd"], "steps": run["steps"],
                       "eval_batches": run["evals"], "seconds": run["seconds"]}
                for name, run in mlmctx["runs"].items()},
        "mlm_head_step_loss_rel_err_vs_plain": mlmctx["steps"]["head_loss_rel_err"],
        T33: {"serve_launches": t33ctx["launches"]["attention_fwd"],
              "serve_cos_min": t33ctx["cos_min"], "serving": t33ctx["times"],
              "train_packed": {"launches": t33train["packed"]["launches"]["attention_fwd"],
                               "chunk_forwards_per_step": t33train["packed"]["chunks_per_step"],
                               "pairs_per_s": pairs_per_s[f"{T33}_packed"],
                               "embeddings_cos_min_vs_plain": t33train["embeddings_cos_min"],
                               "step_check": t33train["step_check"]}},
        "families": families,
        "train_dp": {"world1_nccl": dpctx["world1"]["steps"], "gloo2_one_card":
                     dpctx["gloo"]["steps"], "refusal": dpctx["refusal"]},
        "tp": {"forwards": tpctx["gloo"]["forwards"], "steps_gloo2_one_card":
               tpctx["gloo"]["steps"], "mlm_world1_nccl": tpctx["mlm_world1"],
               "refusal": tpctx["refusal"]},
    }, {
        "name": "attention_bwd", "phase": "train_finetune", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "protein_clip_tpu/ops/attention_pallas.py:287",
        "launches": tctx["finetune"]["launches"]["attention_bwd"],
        "launches_by_path": by_path["attention_bwd"], "max_abs_err": k5_err, **k5_times[0],
        "at_chunks": k5_times[1:3], "dense": k5_times[3], "packed_chunks": k5_times[4:],
        "step_check": steps["finetune"],
        "fault": {k: fault_reads[k] for k in ("attention_bwd_swept_tiles", "attention_bwd_skip")},
        "finetune_pairs_per_s": pairs_per_s["finetune"], "lora_pairs_per_s": pairs_per_s["lora"],
        "train_finetune_packed": {"launches": uctx["finetune"]["launches"]["attention_bwd"],
                                  "chunk_forwards_per_pass": uctx["finetune"]["chunks_per_pass"],
                                  "step_check": steps["finetune_packed"],
                                  "pairs_per_s": pairs_per_s["finetune_packed"],
                                  "lora_pairs_per_s": pairs_per_s["lora_packed"],
                                  "launches_per_step": uctx["per_step"]},
        "head_dims": [{"shape": row["shape"], **row["attention_bwd"]} for row in family_times],
        f"{T33}_train_finetune_packed": {
            "launches": t33train["finetune_packed"]["launches"]["attention_bwd"],
            "attention_fwd_launches": t33train["finetune_packed"]["launches"]["attention_fwd"],
            "chunk_forwards_per_pass": t33train["finetune_packed"]["chunks_per_pass"],
            "step_check": t33train["finetune_step_check"],
            "pairs_per_s": pairs_per_s[f"{T33}_finetune_packed"],
            "launches_per_step": t33train["per_step"]},
        "mlm_finetune_packed": {
            "launches": mlmctx["runs"]["mlm_finetune_packed"]["launches"]["attention_bwd"],
            "steps": mlmctx["runs"]["mlm_finetune_packed"]["steps"],
            "step_check": {k: v for k, v in mlmctx["steps"].items() if k != "head_loss_rel_err"}},
        "train_filip_unfrozen": {"path_chunks_max_abs_err": fmctx["chunks"]["attention_bwd"],
                                 "step_check": steps["filip_unfrozen"],
                                 **{name: {"launches": run["launches"]["attention_bwd"],
                                           "steps": run["steps"],
                                           **filip_more_times[name]}
                                    for name, run in fmctx["runs"].items()
                                    if name not in ("filip_packed_128",
                                                    "filip_packed_128_flat")}},
    }, {
        "name": "attention_fwd_f32", "phase": "f32_serve", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/attention_fwd_f32.cu",
        "replaces": "protein_clip_tpu/ops/attention_pallas.py:105",
        "launches": f32s["launches"]["attention_fwd_f32"],
        "launches_by_path": by_path["attention_fwd_f32"], "max_abs_err": f32_k1_err,
        "shape": f32_times[0]["shape"], **f32_times[0]["attention_fwd_f32"],
        "dense": {"shape": f32_times[1]["shape"], **f32_times[1]["attention_fwd_f32"]},
        "head_dims": [{"shape": row["shape"], **row["attention_fwd_f32"]}
                      for row in f32_times[2:]],
        "fault": {k: fault_reads[k] for k in ("attention_fwd_f32_swept_tiles",
                                              "attention_fwd_f32_skip",
                                              "attention_fwd_f32_attention_f32_tf32")},
        "serve_cos_min_vs_eager_f32": f32s["cos_min"], "serving": f32s["times"],
        "hf_safetensors_mb": hctx["safetensors_mb"], "hf_read_s": hctx["read_s"],
    }, {
        "name": "attention_bwd_f32", "phase": "f32_train_finetune_packed", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/attention_bwd_f32.cu",
        "replaces": "protein_clip_tpu/ops/attention_pallas.py:287",
        "launches": f32train["finetune_packed"]["launches"]["attention_bwd_f32"],
        "launches_by_path": by_path["attention_bwd_f32"], "max_abs_err": f32_k5_err,
        "shape": f32_times[0]["shape"], **f32_times[0]["attention_bwd_f32"],
        "dense": {"shape": f32_times[1]["shape"], **f32_times[1]["attention_bwd_f32"]},
        "head_dims": [{"shape": row["shape"], **row["attention_bwd_f32"]}
                      for row in f32_times[2:]],
        "fault": {k: fault_reads[k] for k in ("attention_bwd_f32_swept_tiles",
                                              "attention_bwd_f32_skip",
                                              "attention_bwd_f32_attention_f32_tf32")},
        "step_check": f32train["step_check"],
        "train_finetune_packed": {
            "pairs_per_s": pairs_per_s["f32_finetune_packed"],
            "peak_memory_gb": f32train["finetune_packed"]["peak_memory_gb"],
            "chunk_forwards_per_pass": f32train["finetune_packed"]["chunks_per_pass"],
            "attention_fwd_f32_launches":
                f32train["finetune_packed"]["launches"]["attention_fwd_f32"]},
    }, {
        "name": "filip_maxsim", "phase": "filip_serve", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/filip_maxsim.cu",
        "replaces": "protein_clip_tpu/ops/filip_pallas.py:33",
        "launches": fctx["launches"]["filip_maxsim"],
        "launches_by_path": by_path["filip_maxsim"], "max_abs_err": k4_err,
        **{key: k4_times[0][key] for key in ("shape", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
        "topk": k4_times[1], "scorer_block": k4_times[2],
        "fault": {k: fault_reads[k] for k in ("maxsim_skip", "maxsim_tf32")},
        "train_filip": {"path_check": ftctx["k4"], "backward_max_rel_err": ftctx["backward_err"],
                        "retrieve_err": ftctx["retrieve_err"], "step_check": steps["filip"],
                        **{name: {"launches": run["launches"]["filip_maxsim"],
                                  "steps": run["steps"], "eval_batches": run["evals"],
                                  **filip_times[name]}
                           for name, run in ftctx["runs"].items()}},
        "train_filip_tiered": {"launches": tiers["filip"]["launches"]["filip_maxsim"],
                               "steps": tiers["filip"]["steps"], "eval_batches":
                               tiers["filip"]["evals"],
                               "launches_per_step": tiers["filip"]["k4_launches_per_step"],
                               "path_check": tiers["filip"]["k4"],
                               "step_check": tiers["filip"]["step_check"],
                               "pairs_per_s": pairs_per_s["filip_tiered"]},
        "train_filip_packed": {"path_check": fmctx["k4"],
                               "backward_on_tier_blocks": fmctx["backward"],
                               "step_check": steps["filip_packed"],
                               **{name: {"launches": run["launches"]["filip_maxsim"],
                                         "steps": run["steps"], "eval_batches": run["evals"],
                                         **filip_more_times[name]}
                                  for name, run in fmctx["runs"].items()
                                  if name in ("filip_packed_128", "filip_packed_128_flat")}},
    }, {
        "name": "infonce", "phase": "train_256", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/infonce.cu",
        "replaces": "protein_clip_tpu/ops/infonce_pallas.py:30",
        "launches": tctx["k2"]["launches"]["infonce"],
        "bwd_launches": tctx["k2"]["bwd"]["infonce"],
        "launches_by_path": by_path["infonce"], "max_abs_err": nce_err["infonce"],
        **nce_times["infonce"][0], "step_check": steps["k2"],
        "fault": {k: fault_reads[k] for k in ("infonce_tf32", "infonce_partial")},
        "train_pairs_per_s": pairs_per_s["k2"], "dispatch": dispatch,
        "train_tiered": {"launches": tiers["run"]["launches"]["infonce"],
                         "bwd_launches": tiers["run"]["bwd"]["infonce"],
                         "step_check": tiers["step_check"]},
        "train_packed": {"launches": pctx["launches"]["infonce"],
                         "bwd_launches": pctx["bwd"]["infonce"], "step_check": steps["packed"],
                         "pairs_per_s": pairs_per_s["packed"],
                         "deterministic": pctx["paths"]["deterministic"],
                         "launches_per_step": pctx["per_step"]},
    }, {
        "name": "infonce_tiled", "phase": "train_1024", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/infonce.cu",
        "replaces": "protein_clip_tpu/ops/infonce_pallas.py:128",
        "launches": tctx["k3"]["launches"]["infonce_tiled"],
        "bwd_launches": tctx["k3"]["bwd"]["infonce_tiled"],
        "launches_by_path": by_path["infonce_tiled"], "max_abs_err": nce_err["infonce_tiled"],
        **nce_times["infonce_tiled"][0], "at_4096": nce_times["infonce_tiled"][1],
        "step_check": steps["k3"],
        "fault": {k: fault_reads[k] for k in ("infonce_tf32", "infonce_partial")},
    }, {
        "name": "dense_mm", "phase": "int8_serve", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/dense_mm.cu",
        "replaces": "tools/probe_int8_pallas.py:19",
        "launches": ictx["launches"]["dense_mm"],
        "launches_by_path": by_path["dense_mm"], "max_abs_err": p1_err["s8_max_abs_err"],
        "bf16_rel_err": p1_err["bf16_rel_err"],
        **{key: p1_times[0][key] for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms")},
        "at_wi_batch32": p1_times[1], "bf16": p1_times[2], "at_128_tokens": short_times["s8"],
        "fault": {k: fault_reads[k] for k in ("dense_mm_s8", "dense_mm_s8_small",
                                              "dense_mm_bf16")},
        "int8_cos_min": ictx["cos_min"], "int8_cos_median": ictx["cos_median"],
        "serving": serving["int8"], "bf16_serving": serving["bf16"],
        "int8_train_pairs_per_s": pairs_per_s["int8"],
    }, {
        "name": "ffn_gelu", "phase": "k6_serve", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/ffn_gelu.cu",
        "replaces": "protein_clip_tpu/ops/ffn_pallas.py:99",
        "launches": k6ctx["launches"]["ffn_gelu"],
        "launches_by_path": by_path["ffn_gelu"], "max_abs_err": k6_err, **k6_times,
        "at_128_tokens": short_times["ffn"],
        "fault": {k: fault_reads[k] for k in ("ffn_gelu", "ffn_gelu_small")},
        "cos_min": k6ctx["cos_min"],
        "serving": serving["k6"],
    }, {
        "name": "ffn_gelu_f32", "phase": "f32_k6_serve", "route": "cuda",
        "source": "protein_clip_tpu_torch/csrc/ffn_gelu_f32.cu",
        "replaces": "protein_clip_tpu/ops/ffn_pallas.py:99",
        "launches": f32k6["launches"]["ffn_gelu_f32"],
        "launches_by_path": by_path["ffn_gelu_f32"], "max_abs_err": k6_f32_err, **k6_f32_times,
        "at_128_tokens": short_times["ffn_f32"],
        "fault": {k: fault_reads[k] for k in ("ffn_gelu_f32_k_tile", "ffn_gelu_f32_tf32")},
        "cos_min_vs_gate_off": f32k6["cos_min"], "max_abs_diff_vs_gate_off": f32k6["max_abs_diff"],
        "serving": f32k6["times"], "gate_off_serving": f32s["times"],
        "train_frozen_step": {k: f32train["frozen_step"][k]
                              for k in ("loss", "gated_loss", "gated_loss_rel_err")},
        "step_check": f32train["step_check"]["k6_gate"],
        "train_finetune_packed": {
            "launches": f32train["finetune_packed_k6"]["launches"]["ffn_gelu_f32"],
            "pairs_per_s": pairs_per_s["f32_k6_finetune_packed"],
            "gate_off_pairs_per_s": pairs_per_s["f32_finetune_packed"],
            "peak_memory_gb": f32train["finetune_packed_k6"]["peak_memory_gb"],
            "chunk_forwards_per_pass": f32train["finetune_packed_k6"]["chunks_per_pass"]},
    }]
    log(f"[figures] {FIGURES['heatmaps']} heatmaps of the training runs: "
        f"{FIGURES['forwards']} backbone forwards, launches {kernel_counts(FIGURES['launches'])}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s; by phase: "
        + ", ".join(f"{name} {sec:.1f} s" for name, sec in seconds.items()))
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": measured_only(kernels)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
