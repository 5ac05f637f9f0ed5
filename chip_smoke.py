#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sar_yolo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. card: name and power limit (nvidia-smi), torch and CUDA versions; TF32 off
     for convolutions and matmuls so the float32 comparisons mean something; the
     C compiler that builds the PNG row filters, the JPEG decoder and encoder and the
     mask contours.
  2. build: nvcc builds every kernel source of the checkout side by side (the
     area attention, and phase 20's int8 convolution and quantization); the area
     attention's ptxas registers and spills are printed (a spill fails), and
     cuobjdump must find tensor-core (HMMA) instructions in its library.
  3. kernel vs plain: every on-path shape of the kernel, float32 and bfloat16,
     against the plain PyTorch version computed in float32 on the same inputs (max abs
     error <= 1e-4 f32, <= 2e-2 bf16; the plain version's own bf16 error is printed),
     gradients through the autograd Function against the plain version's, and
     times (device time of 20 launches replayed from a CUDA graph): kernel,
     plain version, F.scaled_dot_product_attention as a yardstick, and the
     bound (bytes over 3.35 TB/s or FLOPs over 495/3 TFLOP/s f32 / 989 bf16);
     then, for correctness only, channel-contiguous inputs and the chunk
     lengths of imgsz 480 and 320 and of a chunk shorter than one key stage. The timed
     shapes include test-time augmentation's passes at 544 and 448 (Na = 289 and 196).
     At every shape the library's launch plan must equal the wrapper's mirror.
     The timed shapes include those of phase 8's rect batches (Na = 252), of
     yolov12n's batch of 128 in phase 14 (B·area 512 at P4, 128 at P5) and of
     yolov13-JDE's s, l and x scales at 640, batch 8 (4/8, 8/8 and 12/12 heads, C up to
     384; yolov12m's calls are l's).
  4. serving yolov13n-JDE @640: seeded and perturbed weights, 4 ragged 720x1280
     BGR frames through `YOLO.predict_batched`; 8 kernel launches per forward;
     the same detections as the model with `use_flash=False`; head maps of the
     kernel path no farther from the model run in float64 than the plain path's;
     img/s at batch 1 and 8.
  5. serving yolov13n-JDE_P24 @1280, batch 1, with the same checks.
  6. training yolov13n-JDE @640, batch 16, float32, on the port's synthetic data:
     8 kernel launches in each train step's forward and none in its backward;
     3 SGD steps on the kernel path and on `use_flash=False` (cuDNN
     deterministic), each from one shared state on one batch: loss items,
     gradients and the state after the update within the plain path's own
     spread (a rerun, and a run with the attention rounded from float64) or
     within the limits (1e-5 relative on loss items, 1e-4 of each tensor's
     largest magnitude), whichever is larger (`_train_ab`); the total loss
     falls by over 2% in 20 steps on one batch (cuDNN still deterministic);
     step time, img/s, its forward / loss / backward /
     optimizer+EMA split and peak memory; then `YOLO.train(data="synthetic",
     epochs=1, batch=16)`, whose epoch ends in a validation of the EMA weights
     (nc 3: multi-label NMS; 4 x 8 + 8 = 40 kernel launches in all), with the
     validation's share of the epoch, and `predict_batched` on the trained weights.
  7. validation: `YOLO.val(data="synthetic", imgsz=640, batch=16)` on a new seeded
     model and on the trained one, 8 kernel launches each; on the trained one,
     against the model with `use_flash=False` at a threshold where no cut (max_det,
     pre_topk, the threshold itself) decides: the same detections as phase 4 holds
     them, metric dicts with the same keys within 1e-3, and the head maps of the val
     images against float64 as phase 4 holds them; val ms
     per image and its split (batch to the card, forward, decode + NMS, to the
     host, host metrics).
  8. the disk dataset: a JDE dataset of PNG files (rows filtered by all five PNG
     filters) written under runs/: 32 train frames at 720x1280, 24 val frames (16 at
     720x1280, 8 at 1280x720), 1-20 persons of 10-60 px each, 6-column labels;
     `YOLO.train(data=<dict>, imgsz=640, batch=16, epochs=2, close_mosaic=1)` with
     the host augmentation: epoch 1 with mosaic, epoch 2 without, every loss finite,
     2 x (2 x 8 + 2 x 8) = 64 kernel launches; step time against the loader's own time
     per batch; then `YOLO.val(data=<dict>, rect=True)`: batches of 384x672 and
     672x384, 16 launches at Na = 252, the A/B against `use_flash=False` of phase 7,
     ms per image and its split with the loader's part (PNG decode, resize, letterbox).
     The A/B compares the detections over the candidates whose fate in greedy NMS no
     float32 rounding can decide (`_tie_free_dets`): the trained model scores chains of
     overlapping boxes within rounding of each other.
  9. device augmentation and checkpoints, on phase 8's dataset (cuDNN deterministic):
     `YOLO.train(copy_paste=0.0, epochs=2, close_mosaic=1, save_period=1)` takes the
     device route (the loader yields uint8 letterbox tiles; mosaic on the card in epoch
     1 only; 2 x (2 x 8 + 2 x 8) = 64 kernel launches); `device_train_augment` on the
     card against the same function on the CPU with the same draws, on a mosaic and a
     letterbox batch (classes, masks and tags equal, boxes within 1e-6, the image within
     1e-3 of a grey level); the loader alone, the augmentation (CUDA events, median of
     10), the steps, the epochs and the peak memory; weights/{last,best,epoch1,epoch2};
     a second run resumed from epoch1 whose weights/last equals the first run's tensor
     for tensor (parameters, BN statistics, EMA, cb_counts, optimizer, dropout stream;
     32 launches); `YOLO(checkpoint)` serving phase 4's frames and validating rect
     exactly as the object that trained.
 10. JPEG frames through `YOLO.predict` and `YOLO.track` (a seeded, perturbed
     yolov13n-JDE @640): every fixture of tests/data/jpeg/ decodes to the SHA-256 of
     OpenCV's pixels (the progressive one raises); JPEG and PNG decode ms of a 720x1280
     frame; `YOLO.predict` of the 12 frames of tests/data/jpeg/frames/ with 8 kernel
     launches a frame, the same Results as `use_flash=False` (held as phase 4 holds
     them, at a threshold read off a score gap), head maps against float64, frames/s and
     the median split per frame (decode, preprocess, inference, postprocess);
     `YOLO.track` with ByteTrack and with BoT-SORT (`gmc_method: none`): the same ids on
     both paths and the tracker's host ms per frame; `YOLO.val(rect=True)` on the frames
     with their person boxes as labels (JPEG decoded in the loader threads).
 11. `half=True` serving (the BN-folded model folded in float32, then its weights and
     compute in bf16): `YOLO.predict_batched` of yolov13n-JDE @640 (batch 8) and of
     JDE_P24 @1280 (batch 1) on seeded, perturbed weights; 8 launches a forward, all of the
     kernel's bf16 variant and none in float32; the head maps of the kernel path no farther
     (relative L2) from the float32 plain path than twice the bf16 plain path is; img/s
     in float32 and bf16 taken in turns, at batch 1 and 8 (1 at 1280).
 12. `YOLO.predict(half=True)` of the 12 JPEG frames at phase 10's threshold: 96 bf16
     launches a call (none in float32), the head maps held as in phase 11, frames/s in
     float32 and bf16 in turns.
 13. amp training (the default, bf16 compute over float32 parameters) of yolov13n-JDE @640,
     batch 16, synthetic data, SGD: `check_bf16` passes (a fallback to float32 fails the
     phase); one step from one state on one batch on the bf16 kernel path (8 bf16 launches
     in the forward, 0 in the backward), the bf16 plain path, the float32 plain path and
     `remat=True` (cuDNN deterministic): the remat step equals the kernel-path step
     exactly (loss items, every gradient, the state after the update; the HyperACE
     dropout live), the kernel path's train-mode head maps and gradient each no farther
     (relative L2) from the float32 ones than twice the bf16 plain path's; step time, img/s and peak memory of the bf16,
     float32 and remat steps; then `YOLO.train(data="synthetic", epochs=1)` with no
     precision key: bf16 throughout (check_bf16's two forwards, 4 steps, the epoch's
     validation of the bf16 eval copy), and `predict_batched` of the trained model in bf16.
 14. the detect task on `bench.py`'s geometry (ragged uint8 480x640 BGR frames letterboxed
     at 640 on the card): yolov8n, yolo11n and yolov12n served BN-folded (seeded, perturbed
     weights, the class logits scaled to a largest magnitude of 6 so that scores do not tie
     at 1.0), 4 frames one at a time, each at a threshold where NMS's choices do not hang
     on rounding: the same rows as the model in float64 (boxes within what the head maps'
     own float32 rounding moves them) and, for yolov12n, as `use_flash=False` (phase 4's
     gates; 8 kernel launches a forward in float32 and in bf16, none elsewhere); bf16 head
     maps against float32 as phase 11; img/s at batch 1, 8 and 128 in float32 and bf16 in
     turns, at bench.py's conf 0.25, with peak memory and NMS's candidates a frame at 128
     (their stage split is `tools/torch_port_profile.py --phase14`'s); yolo11n-JDE the
     same at batch 8; the kernel's time a yolov12n forward at 128. Training yolov8n @640 (nc 3, synthetic data, SGD): the loss falls
     over 2% in 20 steps on one batch (float32, cuDNN deterministic); step time, img/s, its
     split and peak memory, float32 and amp, at batch 16 and 128; yolov12n's float32 and
     amp train steps (8 launches in the forward, none in the backward); `YOLO.train(epochs=1)`
     of yolov8n with its detect validation, then `YOLO(checkpoint)` served and validated as
     a detect model with its nc and names.
 15. the fork's CBAM JDE configs (seeded, perturbed weights): yolov13n-JDE_CBAM @640 served
     at batch 8 as phase 4 serves (8 kernel launches a forward, the same detections as
     `use_flash=False` at a threshold in a gap of the scores, head maps against float64),
     img/s at batch 1 and 8, and with `half=True` as phase 11; yolov13n-P24_CBAM_JDE @1280,
     batch 1, the same in float32 and bf16 (the kernel at Na = 1600); yolo11n-JDE_CBAM @640
     as phase 14 serves yolo11n-JDE (no kernel), img/s at batch 8; the yolov13n-JDE_CBAM
     train step @640, batch 16: one step kernel against plain in float32 (phase 6's
     `_train_ab`) and in amp (phase 13's `_amp_ab`), step ms (median of 3 after 2) and
     peak memory in both; then the facade: `YOLO.train(epochs=1)` with a callback on each
     of the ten trainer events (each called at the expected count, at epoch 0), `save` and
     `YOLO(checkpoint)` serving the same detections, `fuse()` serving the same detections,
     `info(detailed=True)`, `profile()`, and an `Ensemble` of two checkpoints over the 12
     JPEG frames (192 launches).
 16. the rest of the detect family, none with an A2C2f block: 0 kernel launches in the whole
     phase. yolov10n @640 (NMS-free: `postprocess_end2end`) on phase 14's ragged 480x640
     frames with seeded, perturbed weights and both class-logit copies damped: its rows
     against the model in float64 at a threshold where every frame keeps 50 rows or more,
     over the rows whose float64 score is not within 1e-4 of that threshold or of the
     300th score (boxes within what the head maps' own float32 rounding moves them);
     `half=True` rows finite; `fuse()` (RepVGGDW folded into one 7x7) serving the rows of
     the unfused model, its maps within 4x float32's floor of the unfused ones; img/s at
     batch 1, 8 and 128 in float32 and bf16 in turns at bench.py's conf 0.25, peak memory
     at 128; decode + `postprocess_end2end` ms at batch 128 (CUDA events; run once under
     `torch.cuda.set_sync_debug_mode("error")`: no host sync) beside decode + greedy NMS
     on the same maps. The yolov10n train step @640, batch 16, synthetic nc 3, SGD: the
     dual-assignment loss falls over 2% in 20 steps on one batch (float32, cuDNN
     deterministic); step time, its split and peak memory in float32 and amp;
     `YOLO.train(epochs=1)` with its end2end validation; `YOLO(checkpoint)` served and
     validated as `detect` with head v10Detect. yolov9t, yolov9e (CBLinear / CBFuse),
     yolov5n, yolov3-tiny, yolov6n, yolov8n-ghost at 640 and yolov8n-p6 at 1280 (720x1280
     frames), BN-folded with seeded, perturbed weights and damped class and box logits
     (largest magnitudes 6 and 10: yolov9e's DFL logits reach ~500, where float32
     rounding flips the DFL argmax by a bin): 2 frames
     served one at a time at `_nms_stable_conf` thresholds, the same rows as float64
     (boxes within 2 x the coarsest stride x the maps' float32 distance, over r), bf16
     rows finite; img/s at batch 8 (P6: 1) in float32 and bf16 in turns.
 17. the pose and segment tasks, none with an A2C2f block: 0 kernel launches in the whole
     phase. A 17-keypoint pose dataset (COCO's flip_idx) and a two-class polygon dataset, each
     16 train and 8 val PNG frames at 720x1280 written under runs/ from a seed. yolov8n-pose
     (nc 1, 17 x 3) and yolov8n-seg (nc 80, 32 prototypes) on phase 14's ragged 480x640 frames,
     BN-folded with seeded, perturbed weights and damped class and box logits: 2 frames served
     one at a time at `_nms_stable_conf` thresholds against the model in float64 (boxes and
     keypoint xy within 2 x 32 x the maps' float32 distance or 1e-3 of a 32 px DFL bin,
     scores within 1e-3 or that distance, visibilities within 1e-5 or it; masks equal to
     float64's wherever its probability is not within 1e-4 of 0.5, its logit not within the
     float32 path's own logit distance of 0, and the pixel not on a crop edge within the
     boxes' error); `half=True` rows finite; `fuse()` serving the same rows and masks; img/s
     at batch 1, 8 and 128 (segment: 1 and 8) in float32 and bf16 in turns at conf 0.25,
     peak memory and (segment) the bytes of the rows and masks that cross to the host;
     yolo11n-pose, yolo11n-seg and yolov9c-seg the same at batch 8. The yolov8n-pose train
     step @640, batch 16, on its dataset on the host route (copy_paste 0.1) and the device
     route (copy_paste 0), yolov8n-seg on the host route with copy_paste 0.5, each float32
     and amp: one step's items finite, then 5 timed steps (`_timed_steps`: 3 after 2);
     `YOLO.train(epochs=1)` of each with its (P) or (M) validation, `YOLO.val`, `YOLO(checkpoint)` served
     and validated as its task, and `YOLO.predict` of the 12 JPEG frames (Results.keypoints,
     Results.masks).
 18. the OBB and classify tasks, none with an A2C2f block: 0 kernel launches in the whole
     phase. yolov8n-obb (nc 80) at 1024 on 8 seeded aerial tiles (terrain and rotated
     rectangles), BN-folded with seeded, perturbed weights and class, box and angle logits
     damped on all 8 tiles: the decoded rows of the float32 path and of the model in float64 through the
     rotated NMS, each tile at the threshold of its 1000th best score, over the candidates
     whose fate no float32 rounding decides (`_tie_free_obb`): the same rows, boxes within
     1e-3 px or 2 strides x the maps' own float32 distance, angles within 1e-5 rad or pi/4 x
     that distance (whichever is larger), scores within 1e-5; `half=True` and `fuse()` rows; img/s at batch 1 and 8 in float32 and bf16 in
     turns; decode + rotated NMS ms at batch 8 (CUDA events) with NMS's candidates a tile
     at conf 0.25 and its fixed-point iterations; yolo11n-obb at batch 8. The yolov8n-obb train
     step @1024, batch 8, on the synthetic set (nc 3), float32 and amp (`_timed_steps`), then
     `YOLO.train(epochs=1)` with its OBB validation, `YOLO.val`, `YOLO(checkpoint)` served and
     validated as `obb`, and `YOLO.predict` of the 12 JPEG frames (Results.obb).
     yolov8n-cls (nc 1000) at 224 on phase 14's ragged 480x640 frames: probabilities within
     1e-5 of float64 and the same top-5 up to the first rank that rounding could decide,
     `half=True`, `fuse()`, img/s at batch 1, 8 and 128 in float32 and bf16 in turns;
     yolo11n-cls and yolo11n-cls-resnet18 the same at batch 8. A class-folder dataset of PNG
     frames (4 classes x 32 train / 8 val, 240x320) written under runs/; the yolov8n-cls
     train step @224, batch 64, float32 and amp; `YOLO.train(epochs=1)` with its top-1 / top-5
     validation, `YOLO.val` and `YOLO(checkpoint)`.
 19. RT-DETR and YOLO-World, no graph of theirs with an A2C2f block: 0 kernel launches in
     the whole phase. rtdetr-l (HGNetv2, AIFI, a 6-layer deformable decoder, 300 queries,
     nc 80) at 640 on phase 14's ragged 480x640 frames, seeded perturbed weights with the
     decoder's box deltas damped 0.1x (perturbed random weights make each layer amplify
     rounding ~7x, 12 px after 6 layers); 8 frames against the model in float64, each
     query's row paired by its token: the decoder's own float32 rounding (the float32
     decoder on the float64 model's decoder inputs: boxes within 2e-4 of imgsz, scores
     within 1e-3, no decided class differing) over the frames whose top-300 it picks as
     float64 does, and end to end over the frames where the float32 model picks it too
     (within twice the decoder's own error plus its inputs' rounding's); `half=True`: the
     bf16 decoder on the float32 inputs keeps >= 90% of the top-300 and its boxes within
     10% relative L2 (end to end printed); img/s at batch 1, 8 and 128 in float32 and bf16
     in turns, peak memory. rtdetr-resnet50 and yolov8n-rtdetr the same at batch 8. The
     rtdetr-l train step @640 b16 on the synthetic set (556 queries with the denoising
     ones), float32 and amp, split into forward, the 7 x 16 matching costs, the host
     matching (its one copy included), the loss terms, the backward, optimizer + EMA;
     `RTDETR.train(epochs=1)` with its RTDETRValidator, `YOLO(checkpoint)` serving (300
     rows, no NMS). yolov8s-world after `set_classes(["person", "boat", "car",
     "backpack"])` (the offline encoder) at 640: 2 frames at `_nms_stable_conf` thresholds
     against float64, `half=True`, img/s at batch 1 and 8; yolov8s-worldv2 (BN contrastive
     heads) at batch 8; the yolov8s-world train step @640 b16, float32 and amp; a grounding
     dataset (8 PNG frames, one COCO-style json of captions and spans) through
     `GroundingDataset` and the loader into one World forward.
 20. int8 serving, data parallelism and sharded serving. The int8 path's two kernels
     (`csrc/int8_quant.cu`: abs-max and quantize-pack in one cooperative launch;
     `csrc/int8_conv.cu`: the implicit-GEMM convolution on the int8 tensor cores) print
     ptxas's registers and spills per instantiation (a spill fails); the conv's SASS must
     hold IMMA (or IGMMA) instructions and no IDP4A. At every quantized convolution of one
     int8 forward of yolov13n-JDE and of yolov13l-JDE at 640, batch 8, the quantize
     kernel's xq and sx must equal `int8_quantize_plain`'s byte for byte and the conv's
     int32 sums the plain version's (a float64 convolution of the int8 values); at each
     distinct shape its float32 epilogue lies within 1e-6 relative of the plain one (bf16
     within its rounding); times by CUDA-graph replay of 20 launches: the quantize kernel
     and its plain version, the conv's tile, the conv, its plain version, `torch._int_mm`
     on the unfolded matrices without and with the unfold, cuDNN's bf16 convolution of the
     same shape, and the bounds (bytes over 3.35 TB/s or 2 M N K over 1979 TOP/s; the
     quantize's bytes). torch.profiler counts the device launches of one int8 forward of
     yolov13n-JDE at b8 and of its quantized convs, each on its own input (at most 3 a
     conv; it must see every launch of both kernels). yolov13n-JDE served with `int8=True`
     at batch 1 and 8 and yolov13l-JDE with `int8='auto'` at 8 (seeded, perturbed weights):
     one int8_quantize and one int8_conv call a quantized conv and one area-attention
     launch an AAttn a forward, the head maps and rows equal to the plain int8 path's, each
     path's distance from the float32 fused model, img/s int8 and float32 in turns. The
     yolov13n-JDE train step @640, global batch 16 (float32, cuDNN deterministic): on one
     NCCL rank under DDP, equal to the plain step tensor for tensor (loss items, gradients,
     BN statistics, the state and EMA after the update), 8 area-attention launches counted
     in that step; on two gloo ranks on cuda:0 (8 images each, spawned), the two replicas
     equal to each other, 8 area-attention launches a rank (the three two-rank steps, float32,
     the probe and float64, run in turn in one spawned pair of ranks). The same two-rank step in
     float64, loss included, against the plain step in float64: each gradient and each
     tensor after the update within 1e-6 of its own largest magnitude (or 1e-15 of the
     model's largest, for the gradients that a later train-mode BN makes zero): the
     algorithm. In float32, `_train_ab`'s limits over the spread of the plain path's own
     noise samples (its rerun, its attention rounded from float64, its distance from
     float64, the batch in other orders, each half against float64): the step's loss items
     and its gradient's L2 distance, and, on a probe loss with no discrete decision in it
     (`probe_functional`: a seeded linear functional of the global head outputs), the L2
     distance and each gradient; step ms, the bytes a rank gathers for the loss and the
     forward collectives' share. `predict_batched(mesh_shape=[1])` equal to the unsharded
     call; a mesh of more devices than the card has raises ValueError.
 21. export and artifact serving. yolov13n-JDE @640 (seeded, perturbed weights, its class
     biases shifted so that under 200 anchors a frame pass the artifacts' fixed threshold
     0.25) exported with `YOLO.export(format="pt2")` with embedded NMS and `dynamic=True`, and
     raw; the seconds and bytes of each; each loaded with `YOLO(path)` on the card. The
     program holds 8 `sar_yolo_tpu_torch::flash_area_attention` nodes; on 8 ragged 720x1280
     frames letterboxed on the host (uint8 RGB, the artifacts' input), the NMS artifact's rows
     at batch 1 and 8 (one dynamic program) equal the eager served model's (`decode_nms` on
     the same tensor; phase 4's gates: scores and embeddings within 1e-3, boxes within 1e-3
     px) and the raw (static) artifact's at batch 1 within 1e-3 of the eager ones, each forward
     with 8 kernel launches; torch.profiler over artifact forwards: 8 launches of the kernel
     and of the op a forward, and no aten::einsum beyond the program's own (none of them
     attention), the kernel's device ms a forward in the artifact and in the eager forward;
     img/s at batch 1 and 8 in turns: the artifact, the eager model on the same letterboxed
     batch, eager `predict_batched` of the raw frames. `YOLO(raw artifact).predict` (host
     letterbox) against `YOLO.predict` (letterbox on the card) at a threshold in a gap of the
     scores, on the 12 JPEG frames resized on the host to their letterbox size (both
     letterboxes then only pad): the same count a frame, boxes within 1.5 px, conf within
     5e-3, equal classes (the JAX export tests' round trip); on the JPEG files themselves the
     same comparison is printed, not held (the host letterbox rounds to uint8, the card's
     keeps float32, and random weights turn that into pixels). The raw ONNX artifact at
     320, one frame through the port's numpy runtime on the host against the eager
     predictions on the card (atol 2e-3, rtol 1e-3), its seconds. yolov8n @640 on bench.py's
     480x640 frames: the two pt2 artifacts with the same gates at batch 1 and 8 (no kernel
     launch), img/s in turns.
 22. SAM, MobileSAM, FastSAM and NAS, none with an A2C2f block: 0 area-attention launches in
     the whole phase, read from the counter. `SAM("sam_b")` (ViT-B: embed 768, depth 12, 12
     heads, global attention at blocks 2, 5, 8, 11, 14 x 14 windows, rel-pos) and
     `SAM("mobile_sam")` (TinyViT) at 1024 px, seeded weights, the hypernetworks' last layers
     scaled so that the mask logits reach +-20; each against the same model cast to float64
     on the card, on frame 0 of tests/data/jpeg/frames/ (720x1280 -> 576x1024): the image
     embedding within 1e-4 (max abs; LayerNorm'd values up to ~4.3; 10x float32's measured
     distance), then box prompts for the frame's 6 persons, two points with one negative
     label, and a multimask call for 3 persons: IoU predictions of every slot within 1e-4,
     the masks at the frame's size equal wherever the float64 logit is over 3e-4 from 0 (10x
     the measured logit distance); `generate` with 32 x 32 points, 64 a
     batch: the grid's IoU predictions within 1e-4, thresholds in gaps of the float64 scores
     that at least 20 candidates pass (printed), the same survivors of the filters and greedy
     NMS unless a near-tie decides. The encoder's device ms at batch 1 (CUDA events), its peak
     memory and a global block's logits, one decode of 6 box queries, `generate` ms split into
     device scoring, host NMS and the second decode, its peak memory, `SAM.__call__`'s speed
     split. FastSAM-s @640 with a box prompt on the 12 JPEG frames: the plain YOLO segment
     path's Results filtered by the same prompt, exactly; yolo_nas @640 at batch 1: the plain
     detect path's rows exactly; `NAS.train` raises.
 23. SAM2, no A2C2f block: 0 area-attention launches in the whole phase. `SAM("sam2_b")`
     (Hiera-B+: embed 112, stages 2, 3, 16, 3, 2 heads, global blocks 12, 16, 20, windows 8, 4,
     14, 7; d_model 256, mem_dim 64, 7 memory slots) at 1024 px, seeded weights, the
     hypernetworks' last layers scaled as in phase 22, against the same model cast to float64
     on the card. Image path on frame 0 (720x1280 -> 576x1024): the embedding and both
     high-resolution maps within 7.1e-5, box prompts for the 6 persons, two points with one
     negative, a multimask call and `generate` at 32 x 32 points under phase 22's rules, the
     logit margin 1.5e-4. Video path over the 12 JPEG frames with the 6 persons' boxes on
     frame 0: at each track step the float32 step against the float64 model's step on the
     same bank (cast): the conditioned embedding within 8.6e-5, the masks at the frame's size
     equal wherever the float64 logit is over 1.5e-4 from 0, scores within 1e-4, object logits
     within 8.8e-7, the new memory within 1.4e-4 (the prompted frame's too); the ring's slot
     and tpos against the rule (slot 1 + i % 6; a slot written at step j is min(max(i - j +
     1, 1), 6) back, an empty one 6, slot 0 is 0 back); the 12-frame trajectory's agreement
     with an all-float64 run is printed, not held. `SAM.track`: one Results a frame with
     masks, boxes, the id column and `frame`. Printed: the encoder's device ms at batch 1 and
     its peak memory, a track step's ms split into encode, memory conditioning, decode and
     memory encode at Q = 6 on a full bank, the step's peak memory, `SAM.track`'s frames/s.
     sam2_t, sam2_s and sam2_l build at 1024 and serve one box prompt.
 24. video: tests/data/video/flight.avi (a synthetic UAV flight, 24 Motion-JPEG frames of
     720x1280 at 25 fps, the camera panning and turning) demuxed and decoded on the host:
     every packet's and every frame's SHA-256, fps and frame count equal the fixture's
     digests of cv2.VideoCapture's (decode ms a frame printed); GMC("sparseOptFlow") on the
     host over the frames within 1e-5 (2x2) and 1e-3 px (translation) of the JAX package's
     warps (GMC ms a frame printed). `YOLO.track` of a seeded, perturbed yolov13n-JDE @640
     over the file with ByteTrack and with BoT-SORT + sparseOptFlow (phase 10's thresholds,
     read off this video's scores): 8 kernel launches a frame, the same ids as the
     `use_flash=False` run and rows within phase 10's bound, one tracker at the file's 25
     fps; frames/s and a frame's split into decode, forward, and GMC plus the tracker. Then
     a `.streams` list of two copies of the file with `stream_buffer=True`: 48 frames, 384
     launches, each source's tracks those of the file's run.
 25. the facade's remaining modes at 640 (seeded, perturbed weights). The command line:
     `python -m sar_yolo_tpu_torch version` and `checks` in two subprocesses (exit 0, `checks`
     names the card); `entrypoint(["jde", "predict", "model=<checkpoint>", ...])` of the 12
     JPEG frames with the rows of `YOLO.predict` of the same model (96 launches) and `jde
     track` of flight.avi (192). Test-time augmentation of yolov13n (its YAML's nc 6, class logits
     damped as phase 14 damps them): `YOLO.predict(
     augment=True)` of the 12 frames, 24 launches a frame (passes at 640, 544 and 448: Na 400,
     289 and 196), the same rows as `use_flash=False` at a threshold where NMS's choices do not
     hang on rounding (phase 14's `_nms_stable_conf`; boxes within phase 10's bound, scores
     within 1e-3 and the threshold's margin); `half=True`: 288 bf16 launches, the three
     passes' predictions of the bf16 kernel path no farther (relative L2) from the float32
     plain path's than twice the bf16 plain path's; `YOLO.val(augment=True)` at batch 16 (24
     launches), metrics within 1e-3 of the plain path's; yolov13n-JDE with augment=True warns
     and gives augment=False's rows. `YOLO.embed` of the frames at the default layer, [6] and
     [6, 8]: within 1e-4 (relative) of the plain path, launches those of the layers run.
     `YOLO.benchmark(formats=("pt2",))` of yolov13n on the synthetic set: no error row, the
     pt2 row's mAP50-95 within 1e-3 of the native one's. `YOLO.tune` of yolov13n-JDE, 2
     trials of one epoch at batch 16 (float32): two finite rows in tune_results.csv, 80
     launches. batch=-1: the batch the trainer picks for yolov13n-JDE in float32, one train
     step at it, its peak memory within 0.8 of the card's.
 26. annotated output of yolov13n-JDE @640 (seeded perturbed weights, phase 10's threshold):
     `YOLO.predict(save=True)` of the 12 JPEG frames (96 launches), every written file the
     JPEG (`encode_jpeg`, libjpeg-turbo's bytes) of its Results' `plot()`; `save_crop` of one
     frame, each crop the JPEG of the frame's pixels; `YOLO.track(save=True)` of flight.avi
     with ByteTrack (192 launches), the written AVI read back by `AviReader` (24 frames, 25
     fps, 720x1280), each frame the JPEG of its `plot()`; both paths again with
     `use_flash=False`: the same track ids, rows within phase 10's bound, the plotted frames
     equal wherever plot() reads the two paths' rows alike (every box coordinate truncating
     to the same integer, the same labels), and in the frames excluded by that rule (counted
     and printed) different only inside the regions of the rows read differently (box, line
     width, label extent);
     `YOLO.predict(half=True, save=True)` (96 bf16 launches); `Masks.xy` of a yolov8n-seg frame
     (each contour the largest of its mask, its points on the mask's border); `auto_annotate`
     of 4 frames with this detector (32 launches) and sam_b at 1024 (seeded, the
     hypernetworks scaled as phase 22 scales them): a polygon file a frame, coordinates in
     [0, 1] with 6 decimals. Prints frames/s with save on and off, the plot and encode ms of
     a 720x1280 frame, the AVI's bytes and auto_annotate's s a frame.
 27. the validator's and trainer's figures (`plots`, on by default: from here on every earlier
     phase's `YOLO.val` and `YOLO.train` draws them too). `YOLO.val` of yolov13n-JDE @640
     (seeded weights, BN set to the first val batch's statistics) on phase 8's 24 PNG
     frames, square and rect, at a threshold in a gap of both paths' row scores that leaves
     under PLOT_ROWS rows an image (the class logits damped to MAX_LOGIT, so that no float32
     score rounds to 1, then shifted so that it is 0.3; NMS at IoU 1.0, so that no near-tie
     of its suppression decides): 8 launches a forward (read off the counter), and both
     again with `use_flash=False`: the confusion matrices equal, the mosaics' drawn rows
     (int corners, class, label) equal within PLOT_BOX_TOL and val_batch0_pred.jpg then byte
     for byte, the labels mosaic byte for byte. A one-epoch `YOLO.train` on the same set:
     its seven figures. `YOLO.val` of yolov8n-seg and yolov8n-pose on phase 17's sets
     and yolov8n-obb on the synthetic set at 1024 (class biases lifted where the median
     image's 10th row scores under 0.25): their figures. Every figure read back by the
     port's decoders at the pixel size of the JAX package's figure size and dpi (mosaics: the
     batch's h x w tiles); prints each figure's host ms and the launches.
 28. a JSON line of the kernels (the area attention: launches by dtype, the bf16 numbers of
     the amp train step's forward, phases 16-19's, 22's and 23's paths at 0, its launches and device
     ms in phase 21's .pt2 program, its times at the TTA shapes; the int8 convolution and the
     int8 quantization: one int8 forward of yolov13n-JDE at 640, batch 8), the card line, and
     the result line.
The earlier phases pass `amp=False`, so their float32 gates and numbers keep their meaning.
Needs no network; builds into sar_yolo_tpu_torch/build/.
"""

from __future__ import annotations

import contextlib
import copy
import json
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# H100 SXM tensor-core peaks. The kernel runs a float32 product as three TF32
# products (split TF32: one TF32 pass misses float32's accuracy), so the least
# time for its float32 work is 3 x FLOPs at the 495 TFLOP/s TF32 rate; the
# 67 TFLOP/s of the CUDA cores is no bound for it.
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12                                   # H100 SXM HBM3
# (label, B, C, H, W, heads, area): the A2C2f attention calls of the served models
KERNEL_SHAPES = [
    ("640 P4 b1", 1, 64, 40, 40, 2, 4), ("640 P5 b1", 1, 128, 20, 20, 4, 1),
    ("640 P4 b4", 4, 64, 40, 40, 2, 4), ("640 P5 b4", 4, 128, 20, 20, 4, 1),
    ("640 P4 b8", 8, 64, 40, 40, 2, 4), ("640 P5 b8", 8, 128, 20, 20, 4, 1),
    ("1280 P4 b1", 1, 64, 80, 80, 2, 4), ("1280 P5 b1", 1, 128, 40, 40, 4, 1),
    ("640 P4 b16", 16, 64, 40, 40, 2, 4), ("640 P5 b16", 16, 128, 20, 20, 4, 1),
    # a 16:9 frame's rect val batch at 640 (384x672): Na = 252, not a multiple of 16
    ("rect 384x672 P4 b16", 16, 64, 24, 42, 2, 4), ("rect 384x672 P5 b16", 16, 128, 12, 21, 4, 1),
    # yolov12n served at bench.py's batch (phase 14)
    ("640 P4 b128", 128, 64, 40, 40, 2, 4), ("640 P5 b128", 128, 128, 20, 20, 4, 1),
    # the other scales of yolov13-JDE served at 640, batch 8 (A2C2f: heads = c2 e / 32;
    # s runs 4 calls of each shape a forward, l and x 8); yolov12m's calls are l's (4 each)
    ("640 P4 b8 s", 8, 128, 40, 40, 4, 4), ("640 P5 b8 s", 8, 256, 20, 20, 8, 1),
    ("640 P4 b8 l, yolov12m", 8, 256, 40, 40, 8, 4), ("640 P5 b8 l, yolov12m", 8, 256, 20, 20, 8, 1),
    ("640 P4 b8 x", 8, 384, 40, 40, 12, 4), ("640 P5 b8 x", 8, 384, 20, 20, 12, 1),
    # test-time augmentation at 640 (phase 25), a served frame: the 0.83 pass at 544 (Na = 289:
    # 1156-byte f32 chunks take 4-byte cp.async, 578-byte bf16 ones element copies) and the
    # 0.67 pass at 448 (Na = 196)
    ("TTA 544 P4 b1", 1, 64, 34, 34, 2, 4), ("TTA 544 P5 b1", 1, 128, 17, 17, 4, 1),
    ("TTA 448 P4 b1", 1, 64, 28, 28, 2, 4), ("TTA 448 P5 b1", 1, 128, 14, 14, 4, 1),
]
# (label, B, C, H, W, heads, area, layout), correctness only: channel-contiguous
# (B, N, C) inputs; imgsz 480 P4 (Na = 225: chunk starts not 16-byte aligned);
# imgsz 320 P4 (Na = 100); a chunk shorter than one 128-key stage (Na = 25)
CHECK_SHAPES = [
    ("640 P4 b2 channel-contiguous", 2, 64, 40, 40, 2, 4, "channels"),
    ("480 P4 b2", 2, 64, 30, 30, 2, 4, "tokens"), ("320 P4 b2", 2, 64, 20, 20, 2, 4, "tokens"),
    ("Na 25", 1, 32, 5, 5, 1, 1, "tokens"),
    # test-time augmentation's val batch of 16 at 640 (phase 25): Na = 289 and 196
    ("TTA 544 P4 b16", 16, 64, 34, 34, 2, 4, "tokens"), ("TTA 544 P5 b16", 16, 128, 17, 17, 4, 1, "tokens"),
    ("TTA 448 P4 b16", 16, 64, 28, 28, 2, 4, "tokens"), ("TTA 448 P5 b16", 16, 128, 14, 14, 4, 1, "tokens"),
]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# both backwards run the plain version's: float32 absolute, bf16 relative to the largest gradient
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LAUNCHES_PER_FORWARD = 8  # 2 A2C2f layers x n=2 x 2 ABlocks
MAIN_BATCH = 4            # frames of the served batch (yolov13n-JDE @640)
HALF_BATCH = 8            # frames of the half-served batch (yolov13n-JDE @640)
TRAIN_IMGSZ, TRAIN_BATCH = 640, 16  # the train step and the validation
PRE_TOPK = 1024           # ops/nms.py: candidates kept before suppression
VAL_IMAGES = 16           # the synthetic val set of YOLO.val and of the trainer
DATA_TRAIN = 32           # phase 8's train frames, 720x1280
DATA_VAL = ((720, 1280),) * 16 + ((1280, 720),) * 8  # phase 8's val frames
RECT_SHAPES = [(384, 672), (672, 384)]  # their rect batches at 640 (JAX's init_rect)
RECT_NA = 252             # the attention's chunk length in both: 24x42/4 at P4, 12x21 at P5
PERSON_STATES = {0: "stands", 1: "seated", 2: "laying_down", 3: "walking", 4: "running",
                 5: "not_defined"}  # SARD.yaml's posture states


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def device_ms(fn, iters: int = 20, reps: int = 7) -> float:
    """Median device time of one call of fn: `iters` calls captured in a CUDA graph."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def event_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median time of one call of fn between CUDA events around `iters` calls
    (no graph: for work that autograd launches from the host)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


@contextlib.contextmanager
def _timed_calls(cls, name: str, calls: list):
    """While active, each call of cls.name appends (host seconds between device
    synchronizes, kernel launches) to `calls`."""
    import torch

    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    orig = getattr(cls, name)

    def timed(self, *args, **kwargs):
        torch.cuda.synchronize()
        n0, t0 = flash_area_attention.launches, time.perf_counter()
        out = orig(self, *args, **kwargs)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, flash_area_attention.launches - n0))
        return out
    setattr(cls, name, timed)
    try:
        yield calls
    finally:
        setattr(cls, name, orig)


def phase_card():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cc = shutil.which("cc") or shutil.which("gcc")
    version = subprocess.run([cc, "--version"], capture_output=True, text=True,
                             timeout=60).stdout.splitlines()[0] if cc else None
    print(json.dumps({"c_compiler": cc, "version": version}))
    return card


def phase_build():
    import os
    import re
    import shutil

    import torch

    from sar_yolo_tpu_torch.ops.cuda import flash_attention as fa
    from sar_yolo_tpu_torch.ops.cuda import int8_conv as ic
    t0 = time.perf_counter()
    # every kernel source at once, one nvcc each (phase 20 reads the int8 builds' logs)
    with ThreadPoolExecutor(2) as pool:
        int8_build = pool.submit(ic.build)
        path, log = fa.build()
        print(f"build: {path.name} in {time.perf_counter() - t0:.2f} s")
        int8_libs = int8_build.result()
    print(f"build: {', '.join(p.name for p, _ in int8_libs)} in "
          f"{time.perf_counter() - t0:.2f} s (side by side)")
    entry = None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '.*flash_area_attention_kernelI(\w+?)Li(\d+)E",
                          line):
            dtype = {"f": "float32", "13__nv_bfloat16": "bfloat16"}.get(m.group(1), m.group(1))
            entry = f"{dtype} stage_bytes={m.group(2)}"
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  {entry}: {line.strip().removeprefix('ptxas info    : ')}")
    for dtype in (torch.float32, torch.bfloat16):  # dynamic, so ptxas does not print it
        geo = fa.launch_geometry((1, 1600, 64), 4, 2, ((0, 1, 1600),) * 2, (0, 0), dtype)
        print(f"  {dtype}: {geo['smem_bytes']} bytes of dynamic shared memory a block")
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
    check(spills and max(spills) == 0, f"register spills in the build: {spills}")
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    hmma = len(re.findall(r"\bHMMA\.", sass))
    print(f"  HMMA instructions in the library: {hmma}")
    check(hmma > 0, "no tensor-core (HMMA) instruction in the built library")


def phase_kernel():
    import torch
    from torch.nn import functional as F

    from sar_yolo_tpu_torch.ops.cuda import flash_attention as fa
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import (area_attention_plain,
                                                             flash_area_attention)
    g = torch.Generator(device="cuda").manual_seed(0)

    def inputs(B, C, H, W, dtype, layout="tokens"):
        qk = torch.randn(B, 2 * C, H, W, device="cuda", generator=g).to(dtype)
        vm = torch.randn(B, C, H, W, device="cuda", generator=g).to(dtype)
        tokens = qk.flatten(2).transpose(1, 2)  # the strided (B, N, C) views AAttn passes
        q, k, v = tokens[..., :C], tokens[..., C:], vm.flatten(2).transpose(1, 2)
        if layout == "channels":
            q, k, v = (t.contiguous() for t in (q, k, v))
        return qk, vm, q, k, v

    def compare(label, dname, q, k, v, heads, area):
        """The kernel against the plain version in float32 on the same inputs (in bf16 the
        plain version rounds its scores and weights, which puts it farther from the exact
        result than the kernel, which accumulates in float32); returns the kernel's max abs
        error, the plain version's own in the inputs' dtype, and the launch plan."""
        geo = fa.geometry_of(q, k, v, heads, area)
        lib_geo = fa.library_geometry(q, k, v, heads, area)
        check(lib_geo == geo, f"{label} {dname}: library plan {lib_geo}, wrapper's mirror {geo}")
        got = flash_area_attention(q, k, v, heads, area)
        want = area_attention_plain(q.float(), k.float(), v.float(), heads, area)
        plain = area_attention_plain(q, k, v, heads, area)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        check(err <= TOL[dname], f"kernel vs plain {label} {dname}: max abs err {err}")
        return err, (plain.float() - want).abs().max().item(), geo

    rows = []
    for label, B, C, H, W, heads, area in KERNEL_SHAPES:
        N, Na = H * W, H * W // area
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            qk, vm, q, k, v = inputs(B, C, H, W, dtype)
            err, plain_err, geo = compare(label, dname, q, k, v, heads, area)
            w = torch.randn(B, N, C, device="cuda", generator=g).to(dtype)
            grads = []
            for fn in (flash_area_attention, area_attention_plain):
                qk_l, v_l = qk.clone().requires_grad_(), vm.clone().requires_grad_()
                t = qk_l.flatten(2).transpose(1, 2)
                (fn(t[..., :C], t[..., C:], v_l.flatten(2).transpose(1, 2), heads, area)
                 * w).sum().backward()
                grads.append((qk_l.grad, v_l.grad))
            grad_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(*grads))
            grad_max = max(b.float().abs().max().item() for b in grads[1])
            check(grad_err <= GRAD_TOL[dname] * (grad_max if dtype == torch.bfloat16 else 1.0),
                  f"kernel gradients {label} {dname}: max abs err {grad_err} (largest {grad_max})")
            q4, k4, v4 = (t.reshape(B * area, Na, heads, 32).transpose(1, 2).contiguous()
                          for t in (q, k, v))
            flops = 4 * (B * area * heads) * Na * Na * 32
            nbytes = 4 * B * N * C * q.element_size()
            t_ops, t_bytes = flops / PEAK_FLOPS[dname] * 1e3, nbytes / PEAK_BYTES * 1e3
            backward_ms = None
            if B == TRAIN_BATCH:  # the train step's shapes
                q_l, k_l, v_l = (t.detach().requires_grad_() for t in (q, k, v))
                out = flash_area_attention(q_l, k_l, v_l, heads, area)
                w = torch.randn_like(out)
                backward_ms = event_ms(lambda: torch.autograd.grad(out, (q_l, k_l, v_l), w,
                                                                   retain_graph=True))
            row = {"shape": label, "dtype": dname, "B_area": B * area, "Na": Na, "heads": heads,
                   "max_abs_err": err, "plain_max_abs_err": plain_err,
                   "grad_max_abs_err": grad_err, "backward_ms": backward_ms,
                   "kernel_ms": device_ms(lambda: flash_area_attention(q, k, v, heads, area)),
                   "plain_ms": device_ms(lambda: area_attention_plain(q, k, v, heads, area)),
                   "library_ms": device_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4)),
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "flops": flops, "bytes": nbytes, "grid": geo["grid"], "warps": geo["warps"],
                   "splits": geo["splits"],
                   "stage_bytes": geo["stage_bytes"], "smem_bytes": geo["smem_bytes"],
                   "blocks_per_sm": fa.blocks_per_sm(geo, dtype)}
            print(json.dumps(row))
            rows.append(row)
    for label, B, C, H, W, heads, area, layout in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            *_, q, k, v = inputs(B, C, H, W, dtype, layout)
            err, plain_err, geo = compare(label, dname, q, k, v, heads, area)
            print(json.dumps({"check": label, "dtype": dname, "Na": H * W // area, "layout": layout,
                              "max_abs_err": err, "plain_max_abs_err": plain_err,
                              "stage_bytes": geo["stage_bytes"]}))
    return rows


def calibrate_bn(model, x):
    """Set every BatchNorm's running statistics to those of the batch x, as training would
    leave them: one forward with only BN in train mode (dropout stays off) at momentum 1.
    Leaves the model in eval mode and BN at momentum 0.03. The CPU tests share it."""
    import torch
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.momentum = 1.0
        bn.train()
    with torch.no_grad():
        model(x)
    model.eval()
    for bn in bns:
        bn.momentum = 0.03


def _perturbed_yolo(name: str, seed: int, imgsz: int, cls=None):
    """YOLO (or `cls`) on cuda with seeded weights, every parameter and BN statistic perturbed.

    The BN statistics are first set to those of a calibration batch
    (`calibrate_bn`), so that activations keep their scale through the depth
    and the scores, boxes and embeddings depend on the image instead of
    collapsing to the head biases.
    """
    import torch

    from sar_yolo_tpu_torch import YOLO
    yolo = (cls or YOLO)(name)
    yolo._ensure_variables(seed)
    model = yolo.model
    gen = torch.Generator().manual_seed(seed + 1)

    def noise(t):
        return torch.randn(t.shape, generator=gen).to(t.device)

    with torch.no_grad():
        for key, p in model.named_parameters():
            if key.endswith(".gate"):  # zero at init: would hide the FullPAD branch
                p.add_(0.5 + 0.5 * torch.rand(p.shape, generator=gen).to(p.device))
            else:
                std = p.std().item() if p.numel() > 1 else 0.0
                p.add_((0.3 * std if std > 0 else 0.1) * noise(p))
    calibrate_bn(model, torch.rand(2, 3, imgsz, imgsz, generator=gen).to(yolo.device))
    with torch.no_grad():
        for bn in (m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)):
            bn.running_mean.add_(0.1 * bn.running_var.sqrt() * noise(bn.running_mean))
            bn.running_var.mul_(0.8 + 0.45 * torch.rand(bn.running_var.shape,
                                                         generator=gen).to(bn.running_var.device))
    return yolo


def _set_flash(yolo, use_flash):
    from sar_yolo_tpu_torch.nn.modules.block import AAttn
    for m in yolo.model.modules():
        if isinstance(m, AAttn):
            m.use_flash = use_flash


def _compare_detections(got, want, n_emb: int, label: str, by_row: bool = False):
    """Same kept rows per frame, matched by class and box (rows of near-equal score may swap
    places); `by_row`: by class, box, score and embedding (boxes clipped to the frame may
    coincide).

    Checks row counts, pairing, classes and states; returns the kept counts and
    the largest box, score and embedding differences for the caller to bound.
    """
    check(got.shape == want.shape, f"{label}: shapes {got.shape} vs {want.shape}")
    kept, errs = [], {"box_err_px": 0.0, "score_err": 0.0, "embed_err": 0.0}
    for b in range(got.shape[0]):
        g, w = got[b][got[b, :, 4] > 0], want[b][want[b, :, 4] > 0]
        check(len(g) > 0, f"{label}: frame {b} keeps no detection")
        check(len(g) < got.shape[1], f"{label}: frame {b} fills all {got.shape[1]} rows; "
              "raise conf so that the max_det cut does not decide the comparison")
        check(len(g) == len(w), f"{label}: frame {b} keeps {len(g)} rows vs {len(w)}")
        check(bool(np.isfinite(g).all()), f"{label}: frame {b} non-finite output")
        # by box within a class: multi-label NMS keeps one box under several classes
        cols = np.r_[0:5, 6:6 + n_emb] if by_row else np.r_[0:4]
        match = (np.abs(g[:, None, cols] - w[None, :, cols]).max(-1)
                 + 1e9 * (g[:, None, 5] != w[None, :, 5])).argmin(1)
        hits = np.bincount(match, minlength=len(w))
        check(hits.max() == 1, f"{label}: frame {b} kept boxes do not pair up one to one; "
              f"rows [box, score, class] of the second unpaired: {w[hits == 0, :6].tolist()}, "
              f"of the first paired to one: {g[hits[match] > 1, :6].tolist()}")
        w = w[match]
        check(np.array_equal(g[:, 5], w[:, 5]), f"{label}: frame {b} classes differ")
        if got.shape[2] > 6 + n_emb:  # JDE posture states
            check(np.array_equal(g[:, 6 + n_emb:].argmax(1), w[:, 6 + n_emb:].argmax(1)),
                  f"{label}: frame {b} states differ")
        parts = [("box_err_px", slice(0, 4)), ("score_err", slice(4, 5))]
        if n_emb:
            parts.append(("embed_err", slice(6, 6 + n_emb)))
        for key, sl in parts:
            errs[key] = max(errs[key], float(np.abs(g[:, sl] - w[:, sl]).max()))
        kept.append(len(g))
    return kept, errs


def _img_per_s(yolo, frames, kw, n: int = 5):
    for _ in range(3):
        yolo.predict_batched(frames, **kw)
    t0 = time.perf_counter()
    for _ in range(n):
        yolo.predict_batched(frames, **kw)
    return n * len(frames) / (time.perf_counter() - t0)


def _candidates(predictor, feats, conf: float) -> list:
    """Serving NMS's candidates a frame (single-label: one an anchor): the anchors whose best
    class score passes `conf`. NMS keeps the first PRE_TOPK of them."""
    preds, _ = predictor.decode(feats)
    return (preds[..., 4:4 + predictor.meta["nc"]].amax(-1) >= conf).sum(1).tolist()


def _maps_errors(yolo, plain, x, conf: float, exact=None):
    """Head maps of the served (BN-folded) models on the letterboxed batch x; `exact`: the
    plain model BN-folded in float64 (made from `plain` if not given).

    Returns the largest differences kernel vs plain, kernel vs the plain model
    in float64 and plain vs float64, and NMS's candidates a frame at `conf`.
    """
    import torch

    if exact is None:
        exact = copy.deepcopy(plain._fused_for_serving()).double()
    with torch.no_grad():
        ref = exact(x.double())
        kern, flat = yolo._fused_for_serving()(x), plain._fused_for_serving()(x)
        candidates = _candidates(yolo._get_predictor({}), kern, conf)

    def err(a, b):
        return max((p.double() - q.double()).abs().max().item() for p, q in zip(a, b))

    return {"maps_kernel_vs_plain": err(kern, flat), "maps_kernel_vs_f64": err(kern, ref),
            "maps_plain_vs_f64": err(flat, ref), "candidates_per_frame": candidates}


def phase_serve(name: str, imgsz: int, conf: float, box_tol: float, batch: int, seed: int,
                throughput_batches):
    """Serve `batch` ragged frames; returns the kernel launches of that one forward.

    `conf` keeps the candidates under NMS's pre_topk and the kept rows under
    max_det, so that the comparison tests thresholding and suppression, not
    the order of near-equal scores at a cut. Scores and embeddings must agree
    to 1e-3, boxes to `box_tol` px. The head maps of the kernel path must lie
    no farther from the plain model run in float64 than twice the plain
    float32 path's own distance: the kernel adds no error of its own. `conf=None`: the
    threshold `_ab_conf` reads off the kernel path's scores of the batch (under max_det
    candidates a frame, in a gap of the scores).
    """
    import torch

    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    yolo = _perturbed_yolo(name, seed, imgsz)
    plain = copy.deepcopy(yolo)
    _set_flash(plain, False)
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (max(batch, *throughput_batches), 720, 1280, 3), np.uint8)
    if conf is None:
        predictor = yolo._get_predictor({"imgsz": imgsz})
        with torch.no_grad():
            preds, _ = predictor.decode(predictor.model(predictor.preprocess(frames[:batch])[0]))
        nc = yolo.meta["nc"]
        conf = _ab_conf(preds[..., 4:4 + nc].amax(-1).double().cpu().numpy(), 300)[0]
    kw = dict(imgsz=imgsz, conf=conf)
    yolo.predict_batched(frames[:1], **kw)  # first call: fuse and warm up
    flash_area_attention.launches = 0
    got = yolo.predict_batched(frames[:batch], **kw)
    launches = flash_area_attention.launches
    check(launches == LAUNCHES_PER_FORWARD,
          f"{name}: {launches} kernel launches in one forward, expected {LAUNCHES_PER_FORWARD}")
    want = plain.predict_batched(frames[:batch], **kw)
    check(flash_area_attention.launches == launches, f"{name}: use_flash=False launched the kernel")
    kept, errs = _compare_detections(got, want, yolo.meta["embed_dim"], name)
    x, _, _ = yolo._get_predictor(kw).preprocess(frames[:batch])
    maps = _maps_errors(yolo, plain, x, conf)
    rates = {f"img_per_s_b{b}": _img_per_s(yolo, frames[:b], kw) for b in throughput_batches}
    print(json.dumps({"serve": name, "imgsz": imgsz, "batch": batch, "conf": conf,
                      "kernel_launches": launches, "kept_per_frame": kept, **errs,
                      "box_tol_px": box_tol, **maps, **rates}))
    check(max(maps["candidates_per_frame"]) < PRE_TOPK,
          f"{name}: over {PRE_TOPK} candidates at conf {conf}")
    check(errs["box_err_px"] <= box_tol, f"{name}: box err {errs['box_err_px']} px")
    check(errs["score_err"] <= 1e-3, f"{name}: score err {errs['score_err']}")
    check(errs["embed_err"] <= 1e-3, f"{name}: embedding err {errs['embed_err']}")
    check(maps["maps_kernel_vs_f64"] <= 2 * maps["maps_plain_vs_f64"],
          f"{name}: kernel path {maps['maps_kernel_vs_f64']} from float64, plain path "
          f"{maps['maps_plain_vs_f64']}")
    return launches, rates


def _train_state(tr) -> dict:
    """Everything a train step reads and writes, copied."""
    return {"model": copy.deepcopy(tr.model.state_dict()),
            "opt": copy.deepcopy(tr.optimizer.opt.state_dict()),
            "ema": [e.clone() for e in tr.ema], "cb": tr.cb_counts.clone(), "step": tr.step,
            "updates": tr.optimizer.updates, "rng": tr.generator.get_state()}


def _set_train_state(tr, state: dict):
    tr.model.load_state_dict(state["model"])
    tr.optimizer.opt.load_state_dict(copy.deepcopy(state["opt"]))
    tr.ema = [e.clone() for e in state["ema"]]
    tr.cb_counts, tr.step = state["cb"].clone(), state["step"]
    tr.optimizer.updates = state["updates"]
    tr.generator.set_state(state["rng"])


def _train_step_parts(tr, batch):
    """One train step; returns (loss items, gradients, kernel launches in the forward and
    in the backward)."""
    import torch

    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    b = tr.to_device(batch)
    flash_area_attention.launches = 0
    feats = tr.model(b["img"])
    torch.cuda.synchronize()
    n_forward = flash_area_attention.launches
    total, items, cb = tr.loss(feats, b)
    total.backward()
    torch.cuda.synchronize()
    launches = (n_forward, flash_area_attention.launches - n_forward)
    grads = {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()}
    tr.update(cb)
    return items.cpu().numpy(), grads, launches


class _RoundedAttention:
    """While active, `use_flash=False` attention runs in float64 and is rounded to float32:
    another float32 result of the same attention, as exact as float32 allows."""

    def __enter__(self):
        from sar_yolo_tpu_torch.nn.modules import block
        self.block, self.plain = block, block.area_attention_plain
        block.area_attention_plain = lambda q, k, v, heads, area: self.plain(
            q.double(), k.double(), v.double(), heads, area).float()

    def __exit__(self, *exc):
        self.block.area_attention_plain = self.plain


def _train_ab(overrides: dict, batches):
    """Kernel path against `use_flash=False` on the same train steps.

    Four trainers from the same seeded init. Plain A runs the steps; before
    each step the others take A's whole state (weights, BN statistics,
    momentum buffers, EMA, counts, dropout RNG), so every step is compared from
    one state on one batch. Plain B reruns A (its run-to-run spread; 0 with
    deterministic cuDNN). Plain C runs A with the attention rounded from
    float64 (`_RoundedAttention`): the step's sensitivity to float32 rounding
    of the attention output, which is all the kernel may change. With
    spread = max(|B - A|, |C - A|): loss items within max(2 spread, 1e-5
    relative; the triplet item 1e-5 of its gain); the gradient vector within
    2x C's global L2 distance, and each gradient tensor within max(4 spread,
    1e-4 of its largest magnitude, 1e-6 of the model's largest gradient); after
    the update, each weight and BN statistic within max(4 spread, 1e-4 of its
    largest magnitude, 1e-7). Step 2's gradient is ill-conditioned (C lies
    ~12% from A in L2), so its L2 limit is loose: the gate discriminates at
    steps 1 and 3. Returns the kernel-path trainer and its kernel launches
    (forward, backward) in one step.
    """
    import torch

    from sar_yolo_tpu_torch.engine.trainer import JDETrainer
    trainers = {}
    for label, use_flash in (("a", False), ("b", False), ("c", False), ("k", None)):
        tr = trainers[label] = JDETrainer(overrides)
        tr.setup()
        _set_flash(tr, use_flash)

    def dist(x, y):
        return (x - y).abs().max().item()

    def ratios(xk, xa, xb, xc, floor):
        return sorted((dist(xk[n], v) / max(4 * max(dist(xb[n], v), dist(xc[n], v)),
                                            1e-4 * v.abs().max().item(), floor), n)
                      for n, v in xa.items() if v.is_floating_point())

    def flat(g, names):
        return torch.cat([g[n].flatten() for n in names])

    for step, batch in enumerate(batches):
        state = _train_state(trainers["a"])
        out, after = {}, {}
        for label, tr in trainers.items():
            if label != "a":
                _set_train_state(tr, state)
            with _RoundedAttention() if label == "c" else contextlib.nullcontext():
                out[label] = _train_step_parts(tr, batch)
            after[label] = tr.model.state_dict()
        (ia, ga, la), (ib, gb, lb), (ic, gc, lc), (ik, gk, lk) = (out[x] for x in "abck")
        check(la == lb == lc == (0, 0) and lk == (LAUNCHES_PER_FORWARD, 0),
              f"train step {step + 1}: kernel launches (forward, backward) plain {la}, {lb}, {lc}, "
              f"kernel path {lk}, expected (0, 0) and ({LAUNCHES_PER_FORWARD}, 0)")
        spread = np.maximum(np.abs(ib - ia), np.abs(ic - ia))
        # the triplet item is a difference of distances on the unit sphere: its
        # scale is that of the distances (order 1) times its gain, not its value
        scale = np.abs(ia)
        scale[3] = max(scale[3], trainers["a"].args.clr)
        item_ratio = (np.abs(ik - ia) / np.maximum(2 * spread, 1e-5 * scale)).max()
        g_max = max(g.abs().max().item() for g in ga.values())
        grad_rows = ratios(gk, ga, gb, gc, 1e-6 * g_max)
        state_rows = ratios(after["k"], after["a"], after["b"], after["c"], 1e-7)
        fa = flat(ga, ga)
        l2 = {x: (flat(g, ga) - fa).norm().item() / fa.norm().item()
              for x, g in (("k", gk), ("b", gb), ("c", gc))}
        l2_ratio = l2["k"] / max(2 * l2["b"], 2 * l2["c"], 1e-30)
        print(json.dumps({"train_ab": {
            "step": step + 1, "items_plain": ia.tolist(), "items_kernel": ik.tolist(),
            "items_rerun_spread": np.abs(ib - ia).tolist(),
            "items_rounding_spread": np.abs(ic - ia).tolist(),
            "items_kernel_err": np.abs(ik - ia).tolist(),
            "items_kernel_rel_err": (np.abs(ik - ia) / np.abs(ia)).max().item(),
            "items_err_over_limit": item_ratio.item(),
            "grad_rel_l2": {"kernel": l2["k"], "rerun": l2["b"], "rounded_attention": l2["c"]},
            "grad_max": g_max, "grad_norm": fa.norm().item(), "grad_tensors": len(ga),
            "grad_tensors_over_1e-4_of_max": {
                x: sum(dist(g[n], v) > 1e-4 * v.abs().max().item() for n, v in ga.items())
                for x, g in (("kernel", gk), ("rounded_attention", gc))},
            "grad_worst": [{"param": n, "err_over_limit": r} for r, n in grad_rows[-4:]],
            "state_worst": [{"name": n, "err_over_limit": r} for r, n in state_rows[-3:]]}}))
        check(item_ratio <= 1, f"train step {step + 1}: kernel-path loss items off by "
              f"{item_ratio:.3g}x the limit")
        check(l2_ratio <= 1, f"train step {step + 1}: kernel-path gradient {l2['k']:.3g} from the "
              f"plain path's (L2, relative), over twice the spread {l2['b']:.3g}, {l2['c']:.3g}")
        check(grad_rows[-1][0] <= 1, f"train step {step + 1}: kernel-path gradient of "
              f"{grad_rows[-1][1]} off by {grad_rows[-1][0]:.3g}x the limit")
        check(state_rows[-1][0] <= 1, f"train step {step + 1}: {state_rows[-1][1]} after the "
              f"update off by {state_rows[-1][0]:.3g}x the limit")
    return trainers["k"], lk


def _timed_steps(tr, batch, n: int = 3, warmup: int = 2):
    """Median host-clock ms of a whole train step (batch to the card, forward, loss,
    backward, optimizer + EMA; synchronized), then medians of each part, timed apart."""
    import torch

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    for _ in range(warmup):
        tr.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = [sync_ms(lambda: tr.train_step(batch))[1] for _ in range(n)]
    parts = {"to_device_ms": [], "forward_ms": [], "loss_ms": [], "backward_ms": [],
             "optimizer_ema_ms": []}
    for _ in range(n):
        b, t = sync_ms(lambda: tr.to_device(batch))
        parts["to_device_ms"].append(t)
        feats, t = sync_ms(lambda: tr.model(b["img"]))
        parts["forward_ms"].append(t)
        (total, _, cb), t = sync_ms(lambda: tr.loss(feats, b))
        parts["loss_ms"].append(t)
        parts["backward_ms"].append(sync_ms(total.backward)[1])
        parts["optimizer_ema_ms"].append(sync_ms(lambda: tr.update(cb))[1])
    return {"step_ms": statistics.median(step),
            "img_per_s": 1e3 * len(batch["img"]) / statistics.median(step),
            **{k: statistics.median(v) for k, v in parts.items()},
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_train(card: str, seed: int = 0):
    """The train step of yolov13n-JDE @640, batch 16, float32, then `YOLO.train`; returns
    the kernel's launches in one train step's forward, its launches by path, the timings
    and the trained YOLO."""
    import torch

    from sar_yolo_tpu_torch import YOLO
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    ab = dict(model="yolov13n-JDE.yaml", data="synthetic", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH,
              seed=seed, optimizer="SGD", nbs=TRAIN_BATCH, warmup_epochs=0.0, amp=False)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    from sar_yolo_tpu_torch.data.build import DataLoader
    from sar_yolo_tpu_torch.engine.trainer import JDETrainer
    train_set, _, _ = JDETrainer(ab).get_dataset()
    loader = DataLoader(train_set, TRAIN_BATCH, seed=seed)
    batches = [b for _, b in zip(range(3), loader)]
    tr, step_launches = _train_ab(ab, batches)

    # the loss falls on one batch. The SGD steps are clipped (the gradient's global
    # norm is far over 10) and the momentum builds from zero, so 20 steps move this
    # loss by a few percent, while it moves up and down by about 1% from step to
    # step; the bar is 2% on means of 3 steps. cuDNN stays deterministic: SGD on this loss turns rounding
    # into another trajectory each run, and so every run reads the same one.
    totals = [tr.train_step(batches[0])[0].item() for _ in range(20)]
    print(json.dumps({"train_fixed_batch_total_loss": totals}))
    check(all(np.isfinite(totals)) and np.mean(totals[-3:]) < 0.98 * np.mean(totals[:3]),
          f"train: the total loss did not fall over 20 steps on one batch: {totals}")

    # the step's time on that batch, with cuDNN's fastest choices
    torch.backends.cudnn.deterministic = False
    timing = _timed_steps(tr, batches[0])
    print(json.dumps({"train_step": f"yolov13n-JDE @{TRAIN_IMGSZ}, batch {TRAIN_BATCH}, float32, "
                      "SGD", **timing}))
    del tr
    torch.cuda.empty_cache()

    # the user's entry point (its epoch ends in a validation), then serving the trained
    # (EMA) weights
    from sar_yolo_tpu_torch.engine.trainer import JDETrainer
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import reset_launches
    yolo = YOLO("yolov13n-JDE.yaml")
    reset_launches()
    t0 = time.perf_counter()
    with _timed_calls(JDETrainer, "setup", []) as setup, \
            _timed_calls(JDETrainer, "validate", []) as val:
        metrics = yolo.train(data="synthetic", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, epochs=1,
                             seed=seed, amp=False, project="runs", name="chip_smoke_train",
                             exist_ok=True)
    train_launches = flash_area_attention.launches
    check(yolo.trainer.model.compute_dtype == torch.float32
          and flash_area_attention.launches_by_dtype["bfloat16"] == 0,
          f"YOLO.train(amp=False): compute dtype {yolo.trainer.model.compute_dtype}, launches "
          f"by dtype {flash_area_attention.launches_by_dtype}")
    train_s = time.perf_counter() - t0
    steps = yolo.trainer.step
    val_batches = -(-VAL_IMAGES // TRAIN_BATCH)
    check(steps == 64 // TRAIN_BATCH and len(val) == 1
          and val[0][1] == val_batches * LAUNCHES_PER_FORWARD
          and train_launches == (steps + val_batches) * LAUNCHES_PER_FORWARD,
          f"YOLO.train: {steps} steps, {len(val)} validations, {train_launches} kernel launches "
          f"({[n for _, n in val]} in the validations)")
    check(all(np.isfinite(list(metrics.values()))), f"YOLO.train: metrics {metrics}")
    for key in ("metrics/mAP50(B)", "metrics/mAP50(S)", "fitness"):
        check(key in metrics, f"YOLO.train: no {key} from the epoch's validation: {metrics}")
    check(yolo.trainer.best_fitness == yolo.trainer.fitness == metrics["fitness"],
          f"YOLO.train: fitness {yolo.trainer.fitness} is not the validator's {metrics['fitness']}")
    epoch_s = train_s - setup[0][0]
    frames = np.random.default_rng(seed).integers(0, 256, (2, 720, 1280, 3), np.uint8)
    flash_area_attention.launches = 0
    dets = yolo.predict_batched(frames, imgsz=TRAIN_IMGSZ, conf=1e-4)
    serve_launches = flash_area_attention.launches
    check(dets.shape == (2, 300, 6 + 256 + 6) and np.isfinite(dets).all(),
          f"predict_batched after training: shape {dets.shape}")
    check(serve_launches == LAUNCHES_PER_FORWARD,
          f"predict_batched after training: {serve_launches} kernel launches")
    print(json.dumps({"yolo_train": metrics, "seconds": train_s, "setup_s": setup[0][0],
                      "epoch_s": epoch_s, "val_s": val[0][0],
                      "val_share_of_epoch": val[0][0] / epoch_s, "steps": steps,
                      "updates": yolo.trainer.optimizer.updates,
                      "optimizer": yolo.trainer.optimizer.name,
                      "matched_state_and_reid": "metrics/state_acc" in metrics,
                      "kernel_launches": train_launches, "served_rows_kept":
                      (dets[..., 4] > 0).sum(1).tolist(), "card": card}))
    return step_launches[0], {"train step forward": step_launches[0],
                              "train step backward": step_launches[1],
                              f"YOLO.train, 1 epoch ({steps} steps + validation)": train_launches,
                              "validation in YOLO.train": val[0][1],
                              "predict_batched after training": serve_launches}, timing, yolo


@contextlib.contextmanager
def _recorded_dets(validator_cls, shapes: list | None = None):
    """While active, the detections each validator hands to update_metrics, per batch (and
    the batch's image height and width in `shapes`)."""
    seen, orig = [], validator_cls.update_metrics

    def update_metrics(self, dets, batch, hw):
        seen.append(np.array(dets))
        if shapes is not None:
            shapes.append(tuple(int(v) for v in hw))
        return orig(self, dets, batch, hw)
    own = "update_metrics" in vars(validator_cls)
    validator_cls.update_metrics = update_metrics
    try:
        yield seen
    finally:
        if own:
            validator_cls.update_metrics = orig
        else:
            del validator_cls.update_metrics


def _val_split(yolo, n: int = 5, dataset=None) -> dict:
    """Median host-clock ms of each part of the first validation batch (16 images at 640),
    each ended by a device synchronize: batch to the card, forward, decode + NMS,
    detections to the host, host metrics; the sample building of the loader's threads
    apart. `dataset`: the val set (default: the synthetic one)."""
    import torch

    from sar_yolo_tpu_torch.cfg.default import get_cfg
    from sar_yolo_tpu_torch.data.build import DataLoader
    from sar_yolo_tpu_torch.data.dataset import SyntheticDataset
    from sar_yolo_tpu_torch.engine.validator import JDEValidator
    meta, model = yolo.meta, yolo._fused_for_serving()
    v = JDEValidator()
    v.meta, v.data, v.conf = meta, {"names": yolo.names}, 0.001
    v.args = get_cfg({"model": yolo.cfg, "imgsz": TRAIN_IMGSZ, "batch": TRAIN_BATCH})
    v.init_metrics()
    if dataset is None:
        dataset = SyntheticDataset(n=VAL_IMAGES, imgsz=TRAIN_IMGSZ, nc=min(meta["nc"], 3),
                                   task="jde")
    loader = DataLoader(dataset, TRAIN_BATCH, shuffle=False, drop_last=False, pad_last=True)

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    parts = {k: [] for k in ("samples_ms", "to_device_ms", "forward_ms", "decode_nms_ms",
                             "to_host_ms", "host_metrics_ms")}
    with torch.no_grad():
        for _ in range(n + 1):
            batch, t = sync_ms(lambda: next(iter(loader)))
            parts["samples_ms"].append(t)
            x, t = sync_ms(lambda: v.preprocess(batch["img"], yolo.device))
            parts["to_device_ms"].append(t)
            feats, t = sync_ms(lambda: model(x))
            parts["forward_ms"].append(t)
            dets, t = sync_ms(lambda: v.postprocess(feats))
            parts["decode_nms_ms"].append(t)
            dets, t = sync_ms(lambda: dets.cpu().numpy())
            parts["to_host_ms"].append(t)
            parts["host_metrics_ms"].append(
                sync_ms(lambda: v.update_metrics(dets, batch, batch["img"].shape[1:3]))[1])
    return {k: statistics.median(t[1:]) for k, t in parts.items()}  # the first is a warm-up


def _ab_conf(scores: np.ndarray, max_det: int, margin: float = 1e-5):
    """A threshold above which every image (a row of `scores`) has fewer than max_det
    scores and no score lies within `margin`: the middle of the lowest gap between
    consecutive scores that is over 2 margin wide (the widest gap where none is).
    Returns (threshold, half its gap)."""
    # each image: under max_det scores above this level
    level = np.sort(scores, 1)[:, -max_det].max() if scores.shape[1] >= max_det else -np.inf
    above = np.unique(scores[scores > level])
    check(len(above) >= 2, f"under 2 scores above {level}")
    gaps = np.diff(above)
    wide = np.flatnonzero(gaps > 2 * margin)
    j = int(wide[0]) if len(wide) else int(gaps.argmax())
    return float((above[j] + above[j + 1]) / 2), float(gaps[j] / 2)


def phase_val(yolo, card: str):
    """`YOLO.val` at 640, batch 16, float32: on a new model with seeded weights (nc 1,
    single-label NMS), then on the trained one (nc 3, multi-label); returns the kernel
    launches of each. The trained one is held against `use_flash=False` (`_val_ab`).
    """
    from sar_yolo_tpu_torch.engine.validator import JDEValidator
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    from sar_yolo_tpu_torch import YOLO
    kw = dict(data="synthetic", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, project="runs",
              name="chip_smoke_val", exist_ok=True)
    fresh = YOLO("yolov13n-JDE.yaml")
    flash_area_attention.launches = 0
    fresh_metrics = fresh.val(**kw)
    fresh_launches = flash_area_attention.launches
    print(json.dumps({"yolo_val_seeded": fresh_metrics, "nc": fresh.meta["nc"],
                      "kernel_launches": fresh_launches, "card": card}))
    check(fresh_launches == -(-VAL_IMAGES // TRAIN_BATCH) * LAUNCHES_PER_FORWARD,
          f"YOLO.val of the seeded model: {fresh_launches} kernel launches")
    check("fitness" in fresh_metrics and all(np.isfinite(list(fresh_metrics.values()))),
          f"YOLO.val of the seeded model: {fresh_metrics}")
    del fresh
    yolo.val(**kw)  # warm-up: BN folding, cuDNN's plans
    flash_area_attention.launches = 0
    with _recorded_dets(JDEValidator) as seen:
        metrics = yolo.val(**kw)
    launches = flash_area_attention.launches
    check(launches == -(-VAL_IMAGES // TRAIN_BATCH) * LAUNCHES_PER_FORWARD,
          f"YOLO.val: {launches} kernel launches")
    for key in ("metrics/mAP50(B)", "metrics/mAP50-95(B)", "metrics/mAP50(S)", "fitness"):
        check(key in metrics and np.isfinite(metrics[key]), f"YOLO.val: {key} in {metrics}")
    dets = np.concatenate(seen)
    check(dets.shape == (VAL_IMAGES, 300, 6 + 256 + 6) and np.isfinite(dets).all(),
          f"YOLO.val: detections of shape {dets.shape}")
    ms_per_image = [metrics["speed/ms_per_image"]] + \
        [yolo.val(**kw)["speed/ms_per_image"] for _ in range(2)]

    # the A/B: candidates from the head maps of the val images
    from sar_yolo_tpu_torch.data.dataset import SyntheticDataset
    ds = SyntheticDataset(n=VAL_IMAGES, imgsz=TRAIN_IMGSZ, nc=min(yolo.meta["nc"], 3), task="jde")
    img = np.stack([ds[i]["img"] for i in range(VAL_IMAGES)])
    ab = _val_ab(yolo, kw, [JDEValidator.preprocess(img, yolo.device)], "YOLO.val")
    split = _val_split(yolo)
    print(json.dumps({"yolo_val": metrics, "kernel_launches": launches,
                      "val": f"yolov13n-JDE @{TRAIN_IMGSZ}, batch {TRAIN_BATCH}, float32, "
                             f"{VAL_IMAGES} synthetic images, after 1 epoch of YOLO.train",
                      "ms_per_image": statistics.median(ms_per_image),
                      "ms_per_image_runs": ms_per_image, **split, **ab, "card": card}))
    return fresh_launches, launches


def _val_ab(yolo, kw: dict, xs: list, label: str, tie_free: bool = False) -> dict:
    """`yolo.val(**kw)` on the kernel path against the model with `use_flash=False`.

    Both validate at a threshold `_ab_conf` picks from the head maps of the val
    batches `xs` (on the card, in the validator's order), where each image has under
    max_det (anchor, class) candidates (so under PRE_TOPK, and under max_det kept
    rows) and no score lies within 1e-5 of it, so that no cut decides the comparison;
    their detections are held to each other as phase 4 holds them, and their metrics
    within 1e-3. The head maps, as phase 4 holds them: the kernel path no farther from
    the model run in float64 than twice the plain path. Returns the numbers.

    `tie_free`: the detections are compared over the candidates whose fate in greedy NMS
    no float32 rounding can decide (`_tie_free_dets`): a model trained on phase 8's
    frames scores chains of overlapping boxes within rounding of each other at the top
    of every image, so no threshold leaves them out (PERF.md section 6).
    """
    import torch

    from sar_yolo_tpu_torch.engine.validator import JDEValidator
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    from sar_yolo_tpu_torch.ops.decode import decode_detect
    meta = yolo.meta
    nc = meta["nc"]
    with torch.no_grad():
        scores = torch.cat([decode_detect(yolo._fused_for_serving()(x), meta["strides"], nc,
                                          meta["reg_max"], extra_sigmoid=meta["state_classes"],
                                          split_extras=meta["embed_dim"])[0][..., 4:4 + nc]
                            .flatten(1) for x in xs])
    conf, margin = _ab_conf(scores.double().cpu().numpy(), 300)
    candidates = int((scores >= conf).sum(1).max())
    plain = copy.copy(yolo)
    plain.model, plain._fused = copy.deepcopy(yolo.model), None
    _set_flash(plain, False)
    with _recorded_dets(JDEValidator) as kseen:
        kmetrics = yolo.val(conf=conf, **kw)
    n0 = flash_area_attention.launches
    with _recorded_dets(JDEValidator) as pseen:
        pmetrics = plain.val(conf=conf, **kw)
    check(flash_area_attention.launches == n0, f"{label}: use_flash=False launched the kernel")
    left_out = None
    if tie_free:
        got, want, left_out = _tie_free_dets(yolo, plain, xs, conf)
    else:
        got, want = np.concatenate(kseen), np.concatenate(pseen)
    frames = [b for b in range(len(got)) if (got[b, :, 4] > 0).any() or (want[b, :, 4] > 0).any()]
    check(len(frames) > 0, f"{label} at conf {conf}: no image keeps a detection")
    kept, errs = _compare_detections(got[frames], want[frames], meta["embed_dim"], label)
    maps = {}
    for x in xs:
        for k, v in _maps_errors(yolo, plain, x, conf).items():
            if k.startswith("maps"):
                maps[k] = max(maps.get(k, 0.0), v)
    check(kmetrics.keys() == pmetrics.keys(),
          f"{label}: metric keys {sorted(kmetrics)} vs {sorted(pmetrics)}")
    metric_err = max(abs(kmetrics[k] - pmetrics[k]) for k in kmetrics if k != "speed/ms_per_image")
    check(candidates < 300, f"{label}: {candidates} candidates at conf {conf}")
    check(errs["score_err"] < margin, f"{label}: score err {errs['score_err']} over the "
          f"threshold's margin {margin}: the threshold may decide the comparison")
    check(maps["maps_kernel_vs_f64"] <= 2 * maps["maps_plain_vs_f64"],
          f"{label}: kernel path {maps['maps_kernel_vs_f64']} from float64, plain path "
          f"{maps['maps_plain_vs_f64']}")
    check(errs["box_err_px"] <= 1e-3, f"{label}: box err {errs['box_err_px']} px")
    check(errs["score_err"] <= 1e-3, f"{label}: score err {errs['score_err']}")
    check(errs["embed_err"] <= 1e-3, f"{label}: embedding err {errs['embed_err']}")
    check(metric_err <= 1e-3, f"{label}: metrics differ by {metric_err} from use_flash=False")
    out = {"ab_conf": conf, "ab_conf_margin": margin, "ab_candidates_max": candidates,
           "ab_kept_per_image": kept, **errs, "ab_metric_max_abs_err": metric_err, **maps}
    if tie_free:
        out["ab_candidates_left_out_per_image"] = left_out
    return out


def _tie_free_dets(yolo, plain, xs: list, conf: float):
    """The validator's decode and NMS (at `conf`, IoU 0.7, max_det 300, as `YOLO.val` runs
    them) of each val image's head maps on the kernel path and on `plain`, over the same
    candidates on both: those whose fate no float32 rounding can decide. A candidate
    (anchor, class) with a score over conf is left out of both when, in the model run in
    float64, its score lies within the margin of conf, or it overlaps another candidate of
    its class by an IoU within the IoU margin of 0.7, or beyond 0.7 with scores within the
    margin. The margins are the reach of float32 rounding in that image: 4 times the plain
    float32 path's largest score distance from float64 (1e-8 at least), and 8 times its
    largest box distance over the smallest candidate side (1e-6 at least). Returns (kernel
    rows, plain rows, candidates left out per image)."""
    import torch

    from sar_yolo_tpu_torch.ops.decode import decode_detect
    from sar_yolo_tpu_torch.ops.nms import non_max_suppression
    meta, nc = yolo.meta, yolo.meta["nc"]
    exact = _float64_copy(yolo)._fused
    got, want, left_out = [], [], []
    for x in xs:
        with torch.no_grad():
            paths = [decode_detect(m(x), meta["strides"], nc, meta["reg_max"],
                                   extra_sigmoid=meta["state_classes"],
                                   split_extras=meta["embed_dim"])
                     for m in (yolo._fused_for_serving(), plain._fused_for_serving())]
            r64 = decode_detect_rows(exact(x.double()), meta)[..., :4 + nc]
        r32 = paths[1][0][..., :4 + nc].double().cpu().numpy()
        for i in range(x.shape[0]):
            s64 = r64[i, :, 4:]
            margin = max(4 * float(np.abs(r32[i, :, 4:] - s64).max()), 1e-8)
            anchor, cls = np.nonzero(s64 >= conf - margin)
            xy, wh = r64[i, anchor, :2], r64[i, anchor, 2:4]
            iou_margin = max(8 * float(np.abs(r32[i, anchor, :4] - r64[i, anchor, :4]).max(initial=0))
                             / max(float(wh.min(initial=np.inf)), 1e-9), 1e-6)
            lo, hi = xy - wh / 2, xy + wh / 2
            inter = np.clip(np.minimum(hi[:, None], hi[None]) - np.maximum(lo[:, None], lo[None]),
                            0, None).prod(-1)
            area = wh.prod(-1)
            iou = inter / (area[:, None] + area[None] - inter)
            sc = s64[anchor, cls]
            same = (cls[:, None] == cls[None]) & ~np.eye(len(cls), dtype=bool)
            close = same & ((np.abs(iou - 0.7) < iou_margin)
                            | ((iou > 0.7) & (np.abs(sc[:, None] - sc[None]) < margin)))
            out = close.any(1) | (np.abs(sc - conf) < margin)
            drop = (torch.as_tensor(anchor[out]), torch.as_tensor(4 + cls[out]))
            for preds, _ in paths:
                preds[i][drop[0].to(preds.device), drop[1].to(preds.device)] = 0.0
            left_out.append(int(out.sum()))
        for dets, (preds, bank) in zip((got, want), paths):
            dets.append(non_max_suppression(preds, conf_thres=conf, iou_thres=0.7, max_det=300,
                                            nc=nc, extras_bank=bank, multi_label=nc > 1)
                        .cpu().numpy())
    return np.concatenate(got), np.concatenate(want), left_out


def decode_detect_rows(feats, meta) -> np.ndarray:
    """Decoded (B, N, 4 + nc + states) rows of head maps, float64 on the host."""
    from sar_yolo_tpu_torch.ops.decode import decode_detect
    rows = decode_detect(feats, meta["strides"], meta["nc"], meta["reg_max"],
                         extra_sigmoid=meta.get("state_classes") or 0,
                         split_extras=meta.get("embed_dim") or 0)
    return (rows[0] if meta.get("embed_dim") else rows).double().cpu().numpy()


def _png_file(rgb: np.ndarray, level: int = 1) -> bytes:
    """An 8-bit RGB PNG file of `rgb` (h, w, 3) whose rows take the five PNG filters
    (None, Sub, Up, Average, Paeth) in turn, so that a decoder meets each."""
    import struct
    import zlib
    h, w, _ = rgb.shape
    x = rgb.reshape(h, w * 3).astype(np.int16)
    left, up, up_left = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    left[:, 3:], up[1:], up_left[1:, 3:] = x[:, :-3], x[:-1], x[:-1, :-3]
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    kinds = np.arange(h) % 5
    pred = np.stack([np.zeros_like(x), left, up, (left + up) // 2, paeth])[kinds, np.arange(h)]
    rows = np.concatenate([kinds[:, None], (x - pred) % 256], 1).astype(np.uint8)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))


def _write_dataset(root: Path, seed: int) -> dict:
    """A YOLO-format JDE dataset of PNG frames under `root`: terrain of coarse colour
    cells with noise, 1-20 persons a frame as boxes of 10-60 px, 6-column labels
    (class cx cy w h person_id). Returns the dataset dict."""
    rng = np.random.default_rng(seed)
    for split, shapes in (("train", ((720, 1280),) * DATA_TRAIN), ("val", DATA_VAL)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i, (h, w) in enumerate(shapes):
            cells = rng.integers(40, 200, (h // 80 + 1, w // 80 + 1, 3), np.uint8)
            img = np.repeat(np.repeat(cells, 80, 0), 80, 1)[:h, :w]
            img = (img + rng.integers(0, 24, (h, w, 3), np.uint8)).astype(np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 21))):
                bw, bh = (int(v) for v in rng.integers(10, 61, 2))
                x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
                img[y1:y1 + bh, x1:x1 + bw] = rng.integers(0, 256, 3, np.uint8)
                rows.append(f"0 {(x1 + bw / 2) / w:.6f} {(y1 + bh / 2) / h:.6f} {bw / w:.6f} "
                            f"{bh / h:.6f} {int(rng.integers(0, 30))}")
            (root / "images" / split / f"{i:04d}.png").write_bytes(_png_file(img))
            (root / "labels" / split / f"{i:04d}.txt").write_text("\n".join(rows) + "\n")
    return {"path": str(root.resolve()), "train": "images/train", "val": "images/val", "nc": 1,
            "names": {0: "person"}, "person_states": PERSON_STATES}


@contextlib.contextmanager
def _chunk_lengths(lengths: list):
    """While active, the chunk length (N / area) of each area-attention call of the model."""
    from sar_yolo_tpu_torch.nn.modules import block
    orig = block.flash_area_attention

    def recorded(q, k, v, num_heads, area):
        lengths.append(q.shape[1] // area)
        return orig(q, k, v, num_heads, area)
    block.flash_area_attention = recorded
    try:
        yield lengths
    finally:
        block.flash_area_attention = orig


def _loader_ms(dataset, mosaic: bool, seed: int) -> float:
    """Host-clock ms per batch of one epoch through the train loader alone (no model)."""
    from sar_yolo_tpu_torch.data.build import DataLoader
    dataset.mosaic_enabled = mosaic
    loader = DataLoader(dataset, TRAIN_BATCH, workers=8, seed=seed)
    loader.set_epoch(0)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return (time.perf_counter() - t0) / n * 1e3


def _load_parts(dataset, n: int = 16) -> dict:
    """Median host-clock ms of the loader's per-image parts on val images: PNG decode,
    the long-side resize to imgsz, the letterbox to its rect batch shape."""
    from sar_yolo_tpu_torch.data import cv
    from sar_yolo_tpu_torch.data.augment import letterbox
    from sar_yolo_tpu_torch.data.imageio import imread
    parts = {"png_decode_ms": [], "resize_ms": [], "letterbox_ms": []}
    for i in range(min(n, len(dataset))):
        t0 = time.perf_counter()
        img = imread(dataset.im_files[i])
        t1 = time.perf_counter()
        h0, w0 = img.shape[:2]
        r = dataset.imgsz / max(h0, w0)
        img = cv.resize(img, (round(w0 * r), round(h0 * r)))
        t2 = time.perf_counter()
        letterbox(img, dataset.batch_shapes[dataset.batch_index[i]], scaleup=False)
        t3 = time.perf_counter()
        for key, t in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(t * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}


def phase_data(card: str, seed: int = 0):
    """Train and validate yolov13n-JDE @640 on a YOLO-format dataset on disk (see the
    module docstring, phase 8). Returns the kernel launches of `YOLO.train` and of the
    rect `YOLO.val`, the loader's ms per batch and the dataset dict (phase 9 reuses it)."""
    import torch

    from sar_yolo_tpu_torch import YOLO
    from sar_yolo_tpu_torch.cfg.default import get_cfg
    from sar_yolo_tpu_torch.data import build
    from sar_yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset
    from sar_yolo_tpu_torch.engine.trainer import JDETrainer
    from sar_yolo_tpu_torch.engine.validator import JDEValidator
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    root = Path("runs") / "chip_smoke_dataset"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    data = _write_dataset(root, seed)
    write_s = time.perf_counter() - t0

    # YOLO.train: the epochs' mosaic state and start times, and each step's host-clock span
    epochs, steps = [], []
    set_epoch, train_step = build.DataLoader.set_epoch, JDETrainer.train_step

    def recorded_set_epoch(self, epoch):
        set_epoch(self, epoch)
        epochs.append((epoch, getattr(self.dataset, "mosaic_enabled", None), time.perf_counter()))

    def recorded_step(self, batch, i=0):
        torch.cuda.synchronize()
        t = time.perf_counter()
        total, items = train_step(self, batch, i)
        torch.cuda.synchronize()
        steps.append((t, time.perf_counter() - t, items.cpu().numpy()))
        return total, items
    build.DataLoader.set_epoch, JDETrainer.train_step = recorded_set_epoch, recorded_step
    yolo = YOLO("yolov13n-JDE.yaml")
    flash_area_attention.launches = 0
    try:
        with _timed_calls(JDETrainer, "validate", []) as val:
            t0 = time.perf_counter()
            metrics = yolo.train(data=data, imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, epochs=2,
                                 close_mosaic=1, workers=8, seed=seed, amp=False, project="runs",
                                 name="chip_smoke_data", exist_ok=True)
            t_end = time.perf_counter()
    finally:
        build.DataLoader.set_epoch, JDETrainer.train_step = set_epoch, train_step
    train_launches = flash_area_attention.launches
    nb = DATA_TRAIN // TRAIN_BATCH
    val_batches = -(-len(DATA_VAL) // TRAIN_BATCH)
    check([(e, m) for e, m, _ in epochs] == [(0, True), (1, False)],
          f"YOLO.train: epochs and mosaic {[(e, m) for e, m, _ in epochs]}, expected mosaic in "
          "epoch 1 only (close_mosaic=1)")
    check(len(steps) == 2 * nb and all(np.isfinite(it).all() for _, _, it in steps),
          f"YOLO.train: {len(steps)} steps, loss items {[it.tolist() for _, _, it in steps]}")
    check(len(val) == 2 and all(n == val_batches * LAUNCHES_PER_FORWARD for _, n in val)
          and train_launches == 2 * (nb + val_batches) * LAUNCHES_PER_FORWARD,
          f"YOLO.train: {train_launches} kernel launches ({[n for _, n in val]} in the validations)")
    check("fitness" in metrics and all(np.isfinite(list(metrics.values()))),
          f"YOLO.train: metrics {metrics}")
    # the host's wait for each batch: from the epoch's start or the last step's end
    starts = [t for _, _, t in epochs]
    waits = []
    for j, (t, dt, _) in enumerate(steps):
        prev = starts[j // nb] if j % nb == 0 else steps[j - 1][0] + steps[j - 1][1]
        waits.append((t - prev) * 1e3)
    train_set = yolo.trainer.train_set
    loader = {"loader_ms_per_batch_mosaic": _loader_ms(train_set, True, seed),
              "loader_ms_per_batch_letterbox": _loader_ms(train_set, False, seed)}
    print(json.dumps({
        "yolo_train_disk": metrics, "dataset_write_s": write_s, "train_s": t_end - starts[0],
        "epoch_s": [starts[1] - starts[0], t_end - starts[1]],
        "val_s": [t for t, _ in val], "mosaic_by_epoch": [m for _, m, _ in epochs],
        "step_ms": [dt * 1e3 for _, dt, _ in steps],
        "step_ms_median": statistics.median(dt * 1e3 for _, dt, _ in steps),
        "wait_for_batch_ms": waits, **loader, "kernel_launches": train_launches,
        "loss_items": [it.tolist() for _, _, it in steps], "card": card}))

    # rect validation of the trained model
    kw = dict(data=data, imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, rect=True, project="runs",
              name="chip_smoke_rect", exist_ok=True)
    yolo.val(**kw)  # warm-up: BN folding, cuDNN's plans for the two shapes
    shapes, lengths = [], []
    flash_area_attention.launches = 0
    with _recorded_dets(JDEValidator, shapes) as seen, _chunk_lengths(lengths):
        vmetrics = yolo.val(**kw)
    val_launches = flash_area_attention.launches
    check(shapes == RECT_SHAPES, f"YOLO.val rect: batch shapes {shapes}, expected {RECT_SHAPES}")
    check(val_launches == len(RECT_SHAPES) * LAUNCHES_PER_FORWARD and set(lengths) == {RECT_NA},
          f"YOLO.val rect: {val_launches} kernel launches at chunk lengths {sorted(set(lengths))}")
    dets = np.concatenate(seen)
    check(dets.shape == (len(DATA_VAL), 300, 6 + 256 + 6) and np.isfinite(dets).all(),
          f"YOLO.val rect: detections of shape {dets.shape}")
    for key in ("metrics/mAP50(B)", "metrics/mAP50-95(B)", "metrics/mAP50(S)", "fitness"):
        check(key in vmetrics and np.isfinite(vmetrics[key]), f"YOLO.val rect: {key} in {vmetrics}")
    ms_per_image = [vmetrics["speed/ms_per_image"]] + \
        [yolo.val(**kw)["speed/ms_per_image"] for _ in range(2)]
    info = check_det_dataset(data)
    ds = YOLODataset(info["val"], imgsz=TRAIN_IMGSZ, hyp=get_cfg(), use_tags=True, task="jde")
    ds.init_rect(TRAIN_BATCH)
    xs = [JDEValidator.preprocess(b["img"], yolo.device)
          for b in build.DataLoader(ds, TRAIN_BATCH, shuffle=False, drop_last=False, pad_last=True)]
    ab = _val_ab(yolo, kw, xs, "YOLO.val rect", tie_free=True)
    print(json.dumps({"yolo_val_rect": vmetrics, "batch_shapes": shapes,
                      "chunk_lengths": sorted(set(lengths)), "kernel_launches": val_launches,
                      "ms_per_image": statistics.median(ms_per_image),
                      "ms_per_image_runs": ms_per_image, **_val_split(yolo, dataset=ds),
                      **_load_parts(ds), **ab, "card": card}))
    return train_launches, val_launches, loader, data


def _augment_vs_cpu(tr, batch: dict, mosaic: bool, seed: int) -> dict:
    """`device_train_augment` on the card against the CPU with the same draws (batch 0 of
    epoch 0's), then its time on the card (CUDA events, median of 10 calls)."""
    import torch

    from sar_yolo_tpu_torch.data.device_augment import device_train_augment, draw_params
    B, S = batch["img"].shape[:2]
    params = draw_params(np.random.default_rng((seed, 0, 0)), B, S, tr.aug_hyp, mosaic,
                         partner_span=B, M=batch["bboxes"].shape[1])

    def run(device):
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        return lambda: device_train_augment(b, params.to(device), tr.aug_hyp, mosaic=mosaic,
                                            partner_span=B)
    on_card = run(tr.device)
    got, want = on_card(), run("cpu")()
    torch.cuda.synchronize()
    got = {k: v.cpu() for k, v in got.items()}
    label = "mosaic" if mosaic else "letterbox"
    for k in ("cls", "mask", "tags"):
        check(torch.equal(got[k], want[k]), f"device augmentation, {label} batch: {k} differs "
              "between the card and the CPU")
    # the boxes' division by S may run as a product with 1/S on the card (1 ulp apart)
    box_err = (got["bboxes"] - want["bboxes"]).abs().max().item()
    img_err = 255 * (got["img"] - want["img"]).abs().max().item()
    check(box_err <= 1e-6 and img_err <= 1e-3, f"device augmentation, {label} batch: boxes "
          f"{box_err} apart, image {img_err} grey levels apart (card vs CPU)")
    return {f"{label}_labels_kept": int(got["mask"].sum()), f"{label}_box_err": box_err,
            f"{label}_img_err_grey_levels": img_err,
            f"{label}_augment_ms": event_ms(on_card, iters=1, reps=10)}


def _diff_states(a, b, path: str = "") -> list:
    """(distance, name) of every tensor, number or list entry that differs between two
    checkpoint states."""
    import torch
    if isinstance(a, dict):
        check(a.keys() == b.keys(), f"checkpoint keys at '{path}': {sorted(a)} vs {sorted(b)}")
        return [d for k in a for d in _diff_states(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        check(len(a) == len(b), f"checkpoint lengths at '{path}'")
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _diff_states(x, y, f"{path}/{i}")]
    if isinstance(a, torch.Tensor):
        if torch.equal(a, b):
            return []
        return [((a.double() - b.double()).abs().max().item(), path)]
    return [] if a == b else [(float("inf"), path)]


def phase_checkpoint(card: str, data: dict, host_loader: dict, seed: int = 0):
    """Train on phase 8's dataset through the device augmentation, resume, and serve the
    checkpoints (see the module docstring, phase 9). Returns its kernel launches by path."""
    import torch

    from sar_yolo_tpu_torch import YOLO
    from sar_yolo_tpu_torch.data import build
    from sar_yolo_tpu_torch.engine.trainer import JDETrainer
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    from sar_yolo_tpu_torch.utils.checkpoint import load_checkpoint
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    kw = dict(data=data, copy_paste=0.0, epochs=2, close_mosaic=1, imgsz=TRAIN_IMGSZ,
              batch=TRAIN_BATCH, workers=8, seed=seed, amp=False, project="runs", exist_ok=True)
    epochs, steps = [], []
    set_epoch, train_step = build.DataLoader.set_epoch, JDETrainer.train_step

    def recorded_set_epoch(self, epoch):
        set_epoch(self, epoch)
        epochs.append(time.perf_counter())

    def recorded_step(self, batch, i=0):
        check(batch["img"].dtype == np.uint8 and batch["img"].shape == (TRAIN_BATCH, TRAIN_IMGSZ,
                                                                        TRAIN_IMGSZ, 3)
              and set(batch) == {"img", "cls", "bboxes", "mask", "tags"},
              f"device route: the loader's batch {[(k, v.dtype, v.shape) for k, v in batch.items()]}")
        torch.cuda.synchronize()
        t = time.perf_counter()
        total, items = train_step(self, batch, i)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t, self._mosaic_on, items.cpu().numpy()))
        return total, items
    build.DataLoader.set_epoch, JDETrainer.train_step = recorded_set_epoch, recorded_step
    try:
        yolo = YOLO("yolov13n-JDE.yaml")
        torch.cuda.reset_peak_memory_stats()
        flash_area_attention.launches = 0
        metrics = yolo.train(name="chip_smoke_devaug", save_period=1, **kw)
        t_end = time.perf_counter()
        train_launches = flash_area_attention.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        n_first = len(steps)
        resumed = YOLO("yolov13n-JDE.yaml")
        wdir = Path(yolo.trainer.wdir)
        flash_area_attention.launches = 0
        resumed.train(name="chip_smoke_devaug_resumed", resume=str(wdir / "epoch1"), **kw)
        resume_launches = flash_area_attention.launches
    finally:
        build.DataLoader.set_epoch, JDETrainer.train_step = set_epoch, train_step
    tr = yolo.trainer
    nb = DATA_TRAIN // TRAIN_BATCH
    val_batches = -(-len(DATA_VAL) // TRAIN_BATCH)
    check(tr.device_augment and [m for _, m, _ in steps[:n_first]] == [True] * nb + [False] * nb,
          f"YOLO.train(copy_paste=0.0): device route {tr.device_augment}, mosaic by step "
          f"{[m for _, m, _ in steps[:n_first]]}")
    check(n_first == 2 * nb and all(np.isfinite(it).all() for _, _, it in steps)
          and "fitness" in metrics and all(np.isfinite(list(metrics.values()))),
          f"YOLO.train on the device route: {n_first} steps, metrics {metrics}")
    check(train_launches == 2 * (nb + val_batches) * LAUNCHES_PER_FORWARD
          and resume_launches == (nb + val_batches) * LAUNCHES_PER_FORWARD
          and len(steps) == 3 * nb,
          f"device route: {train_launches} and {resume_launches} (resumed) kernel launches, "
          f"{len(steps)} steps")
    names = sorted(p.name for p in wdir.iterdir())
    check(names == ["best", "epoch1", "epoch2", "last"], f"checkpoints {names}")

    # the resumed run against the uninterrupted one: their weights/last, tensor for tensor
    full, full_meta = load_checkpoint(wdir / "last")
    again, again_meta = load_checkpoint(Path(resumed.trainer.wdir) / "last")
    diffs = sorted(_diff_states(again, full), reverse=True)
    check(not diffs and full_meta["step"] == again_meta["step"] == 2 * nb,
          f"resume: {len(diffs)} entries differ from the uninterrupted run, the largest "
          f"{diffs[:5]}; steps {full_meta['step']}, {again_meta['step']}")

    # the augmentation on the card against the CPU, and the loader alone in device mode
    loader = build.DataLoader(tr.train_set, TRAIN_BATCH, workers=8, seed=seed)
    batch = next(iter(loader))
    aug = {**_augment_vs_cpu(tr, batch, True, seed), **_augment_vs_cpu(tr, batch, False, seed)}
    device_loader_ms = _loader_ms(tr.train_set, False, seed)

    # serving and validating the checkpoint: the best epoch's where it is the last, else
    # weights/last, against the YOLO object that trained (it holds the last epoch's EMA)
    best_epoch = json.loads((wdir / "best" / "run_meta.json").read_text())["epoch"]
    ckpt = wdir / ("best" if best_epoch == 1 else "last")
    served = YOLO(str(ckpt))
    frames = np.random.default_rng(0).integers(0, 256, (8, 720, 1280, 3), np.uint8)[:MAIN_BATCH]
    flash_area_attention.launches = 0
    got = served.predict_batched(frames, imgsz=TRAIN_IMGSZ, conf=1e-4)
    serve_launches = flash_area_attention.launches
    want = yolo.predict_batched(frames, imgsz=TRAIN_IMGSZ, conf=1e-4)
    check(got.shape == (MAIN_BATCH, 300, 6 + 256 + 6) and np.array_equal(got, want),
          f"YOLO({ckpt.name}).predict_batched: {np.abs(got - want).max()} from the trained object's")
    vkw = dict(data=data, imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, rect=True, project="runs",
               name="chip_smoke_devaug_val", exist_ok=True)
    flash_area_attention.launches = 0
    vgot = served.val(**vkw)
    val_launches = flash_area_attention.launches
    vwant = yolo.val(**vkw)
    speed = {k for k in vwant if k.startswith("speed/")}
    check(vgot.keys() == vwant.keys() and all(vgot[k] == vwant[k] for k in vwant if k not in speed),
          f"YOLO({ckpt.name}).val rect: {vgot} vs the trained object's {vwant}")
    best = YOLO(str(wdir / "best")).predict_batched(frames, imgsz=TRAIN_IMGSZ, conf=1e-4)
    check(np.isfinite(best).all(), "YOLO(best).predict_batched: non-finite output")
    starts = epochs[:2]
    print(json.dumps({
        "device_augment_train": metrics, "card": card, "peak_memory_gib": peak_gib,
        "epoch_s": [starts[1] - starts[0], t_end - starts[1]],
        "step_ms": [dt * 1e3 for dt, _, _ in steps[:n_first]],
        "step_ms_median": statistics.median(dt * 1e3 for dt, _, _ in steps[:n_first]),
        "loader_ms_per_batch_device_mode": device_loader_ms,
        "loader_ms_per_batch_host_mosaic_phase8": host_loader["loader_ms_per_batch_mosaic"],
        **aug, "resumed_equal": True, "best_epoch": best_epoch + 1, "served": ckpt.name,
        "served_rows_kept": (got[..., 4] > 0).sum(1).tolist(), "kernel_launches": train_launches,
        "resumed_kernel_launches": resume_launches, "loss_items": [it.tolist() for _, _, it in steps]}))
    return {f"YOLO.train device route @{TRAIN_IMGSZ} b{TRAIN_BATCH}, 2 epochs ({2 * nb} steps "
            "+ 2 validations)": train_launches,
            f"YOLO.train resumed from epoch1 ({nb} steps + 1 validation)": resume_launches,
            f"YOLO({ckpt.name}).predict_batched b{MAIN_BATCH}": serve_launches,
            f"YOLO({ckpt.name}).val rect": val_launches}


JPEG_DIR = Path("tests/data/jpeg")  # the committed fixtures (tools/torch_port_jpeg_fixtures.py)
JPEG_FRAMES = 12                    # their 720x1280 frames


def _decode_fixtures(card: str):
    """Every fixture against its digest; single-threaded decode ms of the 720x1280 frames,
    JPEG and (the same pixels) PNG, median of 3 passes over the 12 frames."""
    import hashlib

    from sar_yolo_tpu_torch.data.imageio import decode_jpeg, decode_png, imread
    digests = json.loads((JPEG_DIR / "digests.json").read_text())
    matched = 0
    for group in ("variants", "frames"):
        for name, entry in digests[group].items():
            path = JPEG_DIR / group / name
            if "raises" in entry:
                try:
                    imread(path)
                except NotImplementedError:
                    matched += 1
                    continue
                check(False, f"{path}: decoded, expected NotImplementedError")
            px = imread(path)
            digest = hashlib.sha256(px.tobytes()).hexdigest()
            check(list(px.shape) == entry["shape"] and digest == entry["sha256"],
                  f"{path}: pixels {px.shape} {digest} differ from OpenCV's {entry}")
            matched += 1
    frames = sorted((JPEG_DIR / "frames").glob("*.jpg"))
    jpegs = [f.read_bytes() for f in frames]
    pngs = [_png_file(np.ascontiguousarray(decode_jpeg(b)[..., ::-1])) for b in jpegs]

    def per_frame_ms(decode, files):
        times = []
        for _ in range(3):
            for data in files:
                t0 = time.perf_counter()
                decode(data)
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    out = {"fixtures_matched": matched, "fixtures": sum(len(v) for v in digests.values()),
           "jpeg_decode_ms_720x1280": per_frame_ms(decode_jpeg, jpegs),
           "png_decode_ms_720x1280": per_frame_ms(decode_png, pngs),
           "jpeg_bytes_per_frame": statistics.median(len(b) for b in jpegs),
           "png_bytes_per_frame": statistics.median(len(b) for b in pngs), "card": card}
    print(json.dumps(out))
    check(matched == out["fixtures"], f"{matched} of {out['fixtures']} fixtures matched")


def _results_array(results: list, n_emb: int, n_states: int, max_det: int = 300) -> np.ndarray:
    """Results as phase 4's (B, max_det, 6 + E + S) array: states one-hot, padding rows zero."""
    out = np.zeros((len(results), max_det, 6 + n_emb + n_states), np.float32)
    for b, r in enumerate(results):
        n = len(r)
        out[b, :n, :6] = r.boxes.data[:, :6]
        out[b, :n, 6:6 + n_emb] = r.embeds
        out[b, np.arange(n), 6 + n_emb + r.person_states] = 1.0
    return out


@contextlib.contextmanager
def _timed_function(module, name: str, times: list):
    """While active, each call of module.name appends its host ms to `times`."""
    orig = getattr(module, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    setattr(module, name, timed)
    try:
        yield times
    finally:
        setattr(module, name, orig)


def _gap_threshold(scores: np.ndarray, q: float, margin: float) -> float:
    """The middle of a gap over 2 margin wide between consecutive scores, the one nearest
    their q-quantile."""
    s = np.unique(scores)
    gaps = np.flatnonzero(np.diff(s) > 2 * margin)
    check(len(gaps) > 0, f"no gap over {2 * margin} among {len(s)} scores")
    mids = (s[gaps] + s[gaps + 1]) / 2
    return float(mids[np.abs(mids - np.quantile(s, q)).argmin()])


def _write_tracker_configs(root: Path, high: float, low: float, new: float,
                           gmc_method: str = "none") -> dict:
    """ByteTrack and BoT-SORT (ReID; camera-motion compensation `gmc_method`) YAMLs at these
    thresholds, the other keys as the shipped configs have them but fuse_score off: a
    seeded model's scores (~0.01) would scale every IoU cost past match_thresh."""
    common = (f"track_high_thresh: {high}\ntrack_low_thresh: {low}\nnew_track_thresh: {new}\n"
              "track_buffer: 30\nmatch_thresh: 0.8\nfuse_score: False\n")
    configs = {"bytetrack": "tracker_type: bytetrack\n" + common,
               "botsort": "tracker_type: botsort\n" + common + f"gmc_method: {gmc_method}\n"
                          "proximity_thresh: 0.5\nappearance_thresh: 0.25\nwith_reid: True\n"}
    paths = {}
    for name, text in configs.items():
        paths[name] = root / f"{name}.yaml"
        paths[name].write_text(text)
    return paths


def phase_jpeg(card: str, seed: int = 2) -> dict:
    """JPEG frames through YOLO.predict, YOLO.track and YOLO.val (see the module docstring,
    phase 10). Returns the kernel launches by path."""
    import torch

    from sar_yolo_tpu_torch.data import loaders
    from sar_yolo_tpu_torch.data.imageio import imread
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    from sar_yolo_tpu_torch.ops.decode import decode_detect
    from sar_yolo_tpu_torch.trackers.byte_tracker import BYTETracker, STrack
    _decode_fixtures(card)
    frames_dir = JPEG_DIR / "frames"
    frames = [imread(f) for f in sorted(frames_dir.glob("*.jpg"))]
    check(len(frames) == JPEG_FRAMES, f"{len(frames)} JPEG frames")
    yolo = _perturbed_yolo("yolov13n-JDE.yaml", seed, TRAIN_IMGSZ)
    plain = copy.deepcopy(yolo)
    _set_flash(plain, False)
    meta, n_emb, n_states = yolo.meta, yolo.meta["embed_dim"], yolo.meta["state_classes"]

    # a threshold where no frame has max_det candidates and no score lies within 1e-5
    predictor = yolo._get_predictor({"imgsz": TRAIN_IMGSZ})
    with torch.no_grad():
        scores = torch.cat([decode_detect(predictor.model(predictor.preprocess(f[None])[0]),
                                          meta["strides"], meta["nc"], meta["reg_max"],
                                          extra_sigmoid=n_states, split_extras=n_emb)[0]
                            [..., 4:4 + meta["nc"]].flatten(1) for f in frames])
    # (margin 1e-4: the 12 frames' scores lie dense; the paths' scores part by ~2e-5)
    conf, margin = _ab_conf(scores.double().cpu().numpy(), 300, margin=1e-4)
    kw = dict(imgsz=TRAIN_IMGSZ, conf=conf)

    # YOLO.predict on the folder: kernel path against the plain path
    yolo.predict(str(frames_dir), **kw)  # warm-up: BN folding, cuDNN's plans
    flash_area_attention.launches = 0
    decode_ms, walls = [], []
    with _timed_function(loaders, "imread", decode_ms):
        for _ in range(3):
            t0 = time.perf_counter()
            got = yolo.predict(str(frames_dir), **kw)
            walls.append(time.perf_counter() - t0)
    launches = flash_area_attention.launches
    check(launches == 3 * JPEG_FRAMES * LAUNCHES_PER_FORWARD,
          f"YOLO.predict of {JPEG_FRAMES} JPEG frames: {launches / 3} kernel launches a call")
    n0 = flash_area_attention.launches
    want = plain.predict(str(frames_dir), **kw)
    check(flash_area_attention.launches == n0, "YOLO.predict: use_flash=False launched the kernel")
    check([r.path for r in got] == [r.path for r in want] == [str(f) for f in
                                                             sorted(frames_dir.glob("*.jpg"))],
          "YOLO.predict: the frames' paths or order differ")
    kept, errs = _compare_detections(_results_array(got, n_emb, n_states),
                                     _results_array(want, n_emb, n_states), n_emb,
                                     "YOLO.predict JPEG", by_row=True)
    x, r, _ = yolo._get_predictor(kw).preprocess(np.stack(frames[:2]))
    maps = _maps_errors(yolo, plain, x, conf)
    # boxes: 1e-3 of the coarsest DFL bin (32 px) in the frame's pixels, as phase 5 holds
    # them: these frames' boxes span hundreds of pixels, where float32 rounding of the
    # head maps alone moves them by ~1e-2 px (the maps check below is the arbiter)
    box_tol = 32e-3 / r
    check(maps["maps_kernel_vs_f64"] <= 2 * maps["maps_plain_vs_f64"],
          f"YOLO.predict JPEG: kernel path {maps['maps_kernel_vs_f64']} from float64, plain path "
          f"{maps['maps_plain_vs_f64']}")
    check(errs["score_err"] < margin and errs["box_err_px"] <= box_tol and errs["score_err"] <= 1e-3
          and errs["embed_err"] <= 1e-3, f"YOLO.predict JPEG: {errs}, threshold margin {margin}, "
          f"box tolerance {box_tol} px")
    split = {f"{k}_ms_median": statistics.median(r.speed[k] for r in got)
             for k in ("preprocess", "inference", "postprocess")}
    predict = {"yolo_predict_jpeg": f"yolov13n-JDE @{TRAIN_IMGSZ}, {JPEG_FRAMES} frames of 720x1280",
               "conf": conf, "conf_margin": margin, "kept_per_frame": kept, **errs,
               "box_tol_px": box_tol, **maps,
               "kernel_launches": launches // 3, "frames_per_s": JPEG_FRAMES / statistics.median(walls),
               "frames_per_s_runs": [JPEG_FRAMES / w for w in walls],
               "decode_ms_median": statistics.median(decode_ms), **split, "card": card}
    print(json.dumps(predict))

    # YOLO.track: ByteTrack and BoT-SORT at thresholds from this model's kept scores, each
    # in a gap of them (no score within `margin`, so that the paths' ~2e-5 apart scores
    # take the same side); the low threshold is the predict threshold
    kept_scores = np.concatenate([r.boxes.conf for r in got])
    root = Path("runs") / "chip_smoke_jpeg"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    high, new = (_gap_threshold(kept_scores, q, margin) for q in (0.5, 0.7))
    configs = _write_tracker_configs(root, high, conf, new)
    track = {}
    for name, cfg in configs.items():
        ids, tracker_ms = {}, []
        for label, model in (("kernel", yolo), ("plain", plain)):
            STrack._count = 0
            n0 = flash_area_attention.launches
            with _timed_function(BYTETracker, "update", tracker_ms if label == "kernel" else []):
                res = model.track(str(frames_dir), tracker=str(cfg), **kw)
            if label == "kernel":
                track[f"{name}_kernel_launches"] = flash_area_attention.launches - n0
            ids[label] = [r.boxes.id.astype(int).tolist() for r in res]
        flat = [i for frame in ids["kernel"] for i in frame]
        check(ids["kernel"] == ids["plain"], f"YOLO.track {name}: ids {ids['kernel']} on the "
              f"kernel path, {ids['plain']} on the plain path")
        check(len(flat) > len(set(flat)) > 0, f"YOLO.track {name}: no identity crosses frames: {ids}")
        check(track[f"{name}_kernel_launches"] == JPEG_FRAMES * LAUNCHES_PER_FORWARD,
              f"YOLO.track {name}: {track[f'{name}_kernel_launches']} kernel launches")
        track.update({f"{name}_tracker_ms_per_frame": statistics.median(tracker_ms),
                      f"{name}_tracks": len(set(flat)), f"{name}_rows": len(flat)})
    print(json.dumps({"yolo_track_jpeg": {k: v.read_text() for k, v in configs.items()},
                      **track, "card": card}))

    # YOLO.val(rect=True) on the frames, their person boxes as labels
    digests = json.loads((JPEG_DIR / "digests.json").read_text())
    for split_dir in ("images/val", "labels/val"):
        (root / "data" / split_dir).mkdir(parents=True)
    for name, entry in digests["frames"].items():
        shutil.copy(frames_dir / name, root / "data" / "images" / "val" / name)
        h, w = entry["shape"][:2]
        rows = [f"{c} {(x1 + x2) / 2 / w:.6f} {(y1 + y2) / 2 / h:.6f} {(x2 - x1) / w:.6f} "
                f"{(y2 - y1) / h:.6f} {pid}" for c, x1, y1, x2, y2, pid in entry["persons"]]
        (root / "data" / "labels" / "val" / name).with_suffix(".txt").write_text("\n".join(rows) + "\n")
    data = {"path": str((root / "data").resolve()), "train": "images/val", "val": "images/val",
            "nc": 1, "names": {0: "person"}, "person_states": PERSON_STATES}
    vkw = dict(data=data, imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, rect=True, project="runs",
               name="chip_smoke_jpeg_val", exist_ok=True)
    yolo.val(**vkw)  # warm-up
    flash_area_attention.launches = 0
    metrics = yolo.val(**vkw)
    val_launches = flash_area_attention.launches
    check(val_launches == LAUNCHES_PER_FORWARD and "fitness" in metrics
          and all(np.isfinite(list(metrics.values()))),
          f"YOLO.val rect on JPEG frames: {val_launches} kernel launches, metrics {metrics}")
    print(json.dumps({"yolo_val_jpeg_rect": metrics, "kernel_launches": val_launches,
                      "ms_per_image_runs": [metrics["speed/ms_per_image"]]
                      + [yolo.val(**vkw)["speed/ms_per_image"] for _ in range(2)], "card": card}))
    shutil.rmtree(root, ignore_errors=True)
    return {f"YOLO.predict {JPEG_FRAMES} JPEG frames 720x1280 @{TRAIN_IMGSZ}": launches // 3,
            **{f"YOLO.track {name} {JPEG_FRAMES} JPEG frames": track[f"{name}_kernel_launches"]
               for name in configs},
            f"YOLO.val rect on {JPEG_FRAMES} JPEG frames": val_launches}


def _maps_vs_f32(kernel, plain, f32, x, x32) -> dict:
    """Relative L2 distances of head maps: the bf16 kernel path and the bf16 plain path each
    from the float32 plain path (of the same weights), and from each other."""
    import torch
    with torch.no_grad():
        k, p, f = (torch.cat([t.double().flatten() for t in m(inp)])
                   for m, inp in ((kernel, x), (plain, x), (f32, x32)))

    def d(a, b):
        return ((a - b).norm() / b.norm()).item()
    return {"maps_bf16_kernel_vs_f32": d(k, f), "maps_bf16_plain_vs_f32": d(p, f),
            "maps_bf16_kernel_vs_plain": d(k, p)}


def _check_bf16_launches(expected: int, label: str):
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    by = dict(flash_area_attention.launches_by_dtype)
    check(by == {"float32": 0, "bfloat16": expected},
          f"{label}: kernel launches by dtype {by}, expected {expected} bf16 and no float32")
    return by


def _rates(fn_f32, fn_bf16, rounds: int = 2) -> dict:
    """Alternating measurements of two rates (f32, bf16, f32, bf16, ...): each list and median."""
    runs = {"f32": [], "bf16": []}
    for _ in range(rounds):
        runs["f32"].append(fn_f32())
        runs["bf16"].append(fn_bf16())
    return {**{f"{k}_runs": v for k, v in runs.items()},
            **{k: statistics.median(v) for k, v in runs.items()}}


def phase_half(name: str, imgsz: int, conf: float, batch: int, seed: int, throughput_batches,
               card: str) -> int:
    """`half=True` serving (see the module docstring, phase 11); returns the bf16 kernel
    launches of one forward."""
    import torch

    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention, reset_launches
    yolo = _perturbed_yolo(name, seed, imgsz)
    plain = copy.deepcopy(yolo)
    _set_flash(plain, False)
    frames = np.random.default_rng(seed).integers(0, 256, (max(batch, *throughput_batches), 720,
                                                           1280, 3), np.uint8)
    kw, hkw = dict(imgsz=imgsz, conf=conf), dict(imgsz=imgsz, conf=conf, half=True)
    yolo.predict_batched(frames[:1], **hkw)  # warm-up: fold, cast, cuDNN's plans
    reset_launches()
    got = yolo.predict_batched(frames[:batch], **hkw)
    launched = _check_bf16_launches(LAUNCHES_PER_FORWARD, f"{name} half")["bfloat16"]
    served = yolo._fused_for_serving(True)
    check({p.dtype for p in served.parameters()} == {torch.bfloat16}
          and served.compute_dtype == torch.bfloat16, f"{name} half: the served model is not bf16")
    check(got.shape == (batch, 300, 6 + 256 + 6) and np.isfinite(got).all(),
          f"{name} half: detections of shape {got.shape}, finite {np.isfinite(got).all()}")
    want = plain.predict_batched(frames[:batch], **hkw)
    check(flash_area_attention.launches == LAUNCHES_PER_FORWARD,
          f"{name} half: use_flash=False launched the kernel")
    x, _, _ = yolo._get_predictor(hkw).preprocess(frames[:batch])
    x32, _, _ = yolo._get_predictor(kw).preprocess(frames[:batch])
    check(x.dtype == torch.bfloat16 and x32.dtype == torch.float32, f"{name}: input dtypes")
    maps = _maps_vs_f32(served, plain._fused_for_serving(True), plain._fused_for_serving(), x, x32)
    rates = {}
    for b in throughput_batches:
        r = _rates(lambda: _img_per_s(yolo, frames[:b], kw), lambda: _img_per_s(yolo, frames[:b], hkw))
        rates.update({f"img_per_s_b{b}_{k}": v for k, v in r.items()})
    kept = {"kept_per_frame_bf16_kernel": (got[..., 4] > 0).sum(1).tolist(),
            "kept_per_frame_bf16_plain": (want[..., 4] > 0).sum(1).tolist()}
    print(json.dumps({"serve_half": name, "imgsz": imgsz, "batch": batch, "conf": conf,
                      "bf16_kernel_launches": launched, **kept, **maps, **rates,
                      "card": card}))
    check(maps["maps_bf16_kernel_vs_f32"] <= 2 * maps["maps_bf16_plain_vs_f32"],
          f"{name} half: kernel path {maps['maps_bf16_kernel_vs_f32']} from float32, plain path "
          f"{maps['maps_bf16_plain_vs_f32']}")
    return launched


def phase_half_jpeg(card: str, seed: int = 2) -> int:
    """`YOLO.predict(half=True)` on the 12 JPEG frames (see the module docstring, phase 12);
    returns its bf16 kernel launches."""
    import torch

    from sar_yolo_tpu_torch.data.imageio import imread
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention, reset_launches
    from sar_yolo_tpu_torch.ops.decode import decode_detect
    frames_dir = JPEG_DIR / "frames"
    yolo = _perturbed_yolo("yolov13n-JDE.yaml", seed, TRAIN_IMGSZ)
    plain = copy.deepcopy(yolo)
    _set_flash(plain, False)
    meta = yolo.meta
    # phase 10's threshold: under max_det candidates a frame, in a gap of the float32 scores
    predictor = yolo._get_predictor({"imgsz": TRAIN_IMGSZ})
    with torch.no_grad():
        scores = torch.cat([decode_detect(predictor.model(predictor.preprocess(imread(f)[None])[0]),
                                          meta["strides"], meta["nc"], meta["reg_max"],
                                          extra_sigmoid=meta["state_classes"],
                                          split_extras=meta["embed_dim"])[0]
                            [..., 4:4 + meta["nc"]].flatten(1)
                            for f in sorted(frames_dir.glob("*.jpg"))])
    conf, _ = _ab_conf(scores.double().cpu().numpy(), 300, margin=1e-4)
    kw, hkw = dict(imgsz=TRAIN_IMGSZ, conf=conf), dict(imgsz=TRAIN_IMGSZ, conf=conf, half=True)
    yolo.predict(str(frames_dir), **hkw)  # warm-up
    reset_launches()
    walls = {"f32": [], "bf16": []}
    results, launched = {}, 0
    for _ in range(3):
        for key, args in (("f32", kw), ("bf16", hkw)):
            n0 = dict(flash_area_attention.launches_by_dtype)
            t0 = time.perf_counter()
            results[key] = yolo.predict(str(frames_dir), **args)
            walls[key].append(time.perf_counter() - t0)
            by = {k: v - n0[k] for k, v in flash_area_attention.launches_by_dtype.items()}
            want = JPEG_FRAMES * LAUNCHES_PER_FORWARD
            check(by == ({"float32": want, "bfloat16": 0} if key == "f32"
                         else {"float32": 0, "bfloat16": want}),
                  f"YOLO.predict {key} on JPEG frames: kernel launches by dtype {by}")
            launched += by["bfloat16"]
    got = results["bf16"]
    check(len(got) == JPEG_FRAMES and all(np.isfinite(r.boxes.data).all()
                                         and np.isfinite(r.embeds).all() for r in got),
          "YOLO.predict half: results")
    n0 = flash_area_attention.launches
    want = plain.predict(str(frames_dir), **hkw)
    check(flash_area_attention.launches == n0, "YOLO.predict half: use_flash=False launched the kernel")
    frames = np.stack([imread(f) for f in sorted(frames_dir.glob("*.jpg"))[:2]])
    x, _, _ = yolo._get_predictor(hkw).preprocess(frames)
    x32, _, _ = yolo._get_predictor(kw).preprocess(frames)
    maps = _maps_vs_f32(yolo._fused_for_serving(True), plain._fused_for_serving(True),
                        plain._fused_for_serving(), x, x32)
    out = {"yolo_predict_jpeg_half": f"yolov13n-JDE @{TRAIN_IMGSZ}, {JPEG_FRAMES} frames of "
                                     "720x1280", "conf": conf,
           "bf16_kernel_launches": launched,
           **{f"frames_per_s_{k}": JPEG_FRAMES / statistics.median(v) for k, v in walls.items()},
           **{f"frames_per_s_{k}_runs": [JPEG_FRAMES / w for w in v] for k, v in walls.items()},
           "inference_ms_median_bf16": statistics.median(r.speed["inference"] for r in got),
           "inference_ms_median_f32": statistics.median(r.speed["inference"] for r in results["f32"]),
           "kept_bf16_kernel": [len(r) for r in got], "kept_bf16_plain": [len(r) for r in want],
           "kept_f32": [len(r) for r in results["f32"]], **maps, "card": card}
    print(json.dumps(out))
    check(maps["maps_bf16_kernel_vs_f32"] <= 2 * maps["maps_bf16_plain_vs_f32"],
          f"YOLO.predict half: kernel path {maps['maps_bf16_kernel_vs_f32']} from float32, plain "
          f"path {maps['maps_bf16_plain_vs_f32']}")
    return launched


def _amp_ab(base: dict, seed: int, remat: bool, card: str):
    """One amp train step from one state on one batch on the bf16 kernel path, the bf16
    plain path, the float32 plain path and, with `remat`, `remat=True` (cuDNN
    deterministic; see the module docstring, phase 13), with its checks. Returns the
    trainers, the batch and the kernel's launches in the bf16 step's forward and (with
    `remat`) in the remat step's forward and recomputation."""
    import torch

    from sar_yolo_tpu_torch.data.build import DataLoader
    from sar_yolo_tpu_torch.engine.trainer import JDETrainer
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention, reset_launches
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    trainers = {}
    paths = (("bf16", {}, None), ("bf16_plain", {}, False), ("f32_plain", {"amp": False}, False))
    for label, extra, use_flash in paths + ((("bf16_remat", {"remat": True}, None),) if remat
                                            else ()):
        tr = trainers[label] = JDETrainer({**base, **extra})
        tr.setup()
        _set_flash(tr, use_flash)
        want = torch.float32 if label.startswith("f32") else torch.bfloat16
        check(tr.model.compute_dtype == want, f"amp train {label}: compute dtype "
              f"{tr.model.compute_dtype} (check_bf16 fell back?)")
    loader = DataLoader(trainers["bf16"].train_set, TRAIN_BATCH, seed=seed)
    batch = next(iter(loader))
    state = _train_state(trainers["bf16"])
    heads = {}  # the train-mode head maps of the step's forward
    for label in ("bf16", "bf16_plain", "f32_plain"):
        tr = trainers[label]
        _set_train_state(tr, state)
        with torch.no_grad():
            heads[label] = torch.cat([t.double().flatten()
                                      for t in tr.model(tr.to_device(batch)["img"])])
    out, after, by = {}, {}, {}
    for label, tr in trainers.items():
        _set_train_state(tr, state)
        reset_launches()
        out[label] = _train_step_parts(tr, batch)
        by[label] = dict(flash_area_attention.launches_by_dtype)
        after[label] = tr.model.state_dict()
    (ik, gk, lk), (ip, gp, lp), (if32, gf, lf) = (
        out[x] for x in ("bf16", "bf16_plain", "f32_plain"))
    check(lk == (LAUNCHES_PER_FORWARD, 0) and by["bf16"]["bfloat16"] == LAUNCHES_PER_FORWARD
          and by["bf16"]["float32"] == 0 and lp == lf == (0, 0),
          f"amp train step: kernel launches (forward, backward) {lk}, by dtype {by['bf16']}; "
          f"plain paths {lp}, {lf}")
    remat_equal = None
    if remat:
        ir, gr, lr = out["bf16_remat"]
        # remat recomputes the checkpointed blocks, the attention included, in the backward
        check(lr == (LAUNCHES_PER_FORWARD, LAUNCHES_PER_FORWARD)
              and by["bf16_remat"]["float32"] == 0,
              f"remat step: kernel launches {lr}, by dtype {by['bf16_remat']}")
        remat_equal = (np.array_equal(ir, ik) and all(torch.equal(gr[n], g) for n, g in gk.items())
                       and all(torch.equal(after["bf16_remat"][k], v)
                               for k, v in after["bf16"].items()))

    def flat(g):
        return torch.cat([g[n].double().flatten() for n in gf])

    def d(a, b):
        return ((a - b).norm() / b.norm()).item()
    fk, fp, ff = flat(gk), flat(gp), flat(gf)
    worst = sorted((((gp[n].double() - g.double()).norm().item(), n, g.double().norm().item())
                    for n, g in gf.items()), reverse=True)[:4]
    ab = {"maps_rel_l2_bf16_kernel_vs_f32": d(heads["bf16"], heads["f32_plain"]),
          "maps_rel_l2_bf16_plain_vs_f32": d(heads["bf16_plain"], heads["f32_plain"]),
          "items_bf16_kernel": ik.tolist(), "items_bf16_plain": ip.tolist(),
          "items_f32": if32.tolist(),
          "items_rel_l2_bf16_kernel_vs_f32": float(np.linalg.norm(ik - if32) / np.linalg.norm(if32)),
          "items_rel_l2_bf16_plain_vs_f32": float(np.linalg.norm(ip - if32) / np.linalg.norm(if32)),
          "grad_rel_l2_bf16_kernel_vs_f32": d(fk, ff), "grad_rel_l2_bf16_plain_vs_f32": d(fp, ff),
          "grad_rel_l2_bf16_kernel_vs_plain": d(fk, fp),
          "grad_worst_bf16_plain_vs_f32": [{"param": n, "l2_diff": e, "l2_f32": w}
                                           for e, n, w in worst],
          "remat_step_equal": remat_equal}
    print(json.dumps({"amp_train_ab": ab, "model": base["model"], "card": card}))
    check(remat_equal is not False, "remat=True: the step differs from the plain step")
    check(np.isfinite(ik).all() and np.isfinite(fk.cpu().numpy()).all(), "amp step: not finite")
    check(ab["maps_rel_l2_bf16_kernel_vs_f32"] <= 2 * ab["maps_rel_l2_bf16_plain_vs_f32"],
          f"amp step: kernel-path head maps {ab['maps_rel_l2_bf16_kernel_vs_f32']} from float32, "
          f"plain path {ab['maps_rel_l2_bf16_plain_vs_f32']}")
    check(ab["grad_rel_l2_bf16_kernel_vs_f32"] <= 2 * ab["grad_rel_l2_bf16_plain_vs_f32"],
          f"amp step: kernel-path gradient {ab['grad_rel_l2_bf16_kernel_vs_f32']} from float32, "
          f"plain path {ab['grad_rel_l2_bf16_plain_vs_f32']}")
    # (the 5 loss items are printed, not gated: two bf16 runs part from float32 by rounding
    # noise that 5 numbers do not average, while the gradient's 2.5M entries do)
    launches = {"step_forward": lk[0]}
    if remat:
        launches["remat"] = sum(out["bf16_remat"][2])
    return trainers, batch, launches


def phase_amp_train(card: str, seed: int = 0):
    """The amp train step, remat and a one-epoch `YOLO.train` with amp on (see the module
    docstring, phase 13). Returns the bf16 launches by path and the step timings."""
    import torch

    from sar_yolo_tpu_torch import YOLO
    from sar_yolo_tpu_torch.engine.trainer import JDETrainer
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention, reset_launches
    base = dict(model="yolov13n-JDE.yaml", data="synthetic", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH,
                seed=seed, optimizer="SGD", nbs=TRAIN_BATCH, warmup_epochs=0.0)
    trainers, batch, step_launches = _amp_ab(base, seed, True, card)

    # times and peak memory, cuDNN's fastest choices; the f32 step on its kernel path
    torch.backends.cudnn.deterministic = False
    f32 = trainers.pop("f32_plain")
    _set_flash(f32, None)
    del trainers["bf16_plain"]
    timing = {}
    for label, tr in (("bf16", trainers["bf16"]), ("f32", f32),
                      ("bf16_remat", trainers["bf16_remat"])):
        torch.cuda.empty_cache()
        timing[label] = _timed_steps(tr, batch)
    print(json.dumps({"amp_train_step": f"yolov13n-JDE @{TRAIN_IMGSZ}, batch {TRAIN_BATCH}, SGD",
                      **timing, "card": card}))
    del trainers, f32
    torch.cuda.empty_cache()

    # YOLO.train with no precision key: amp on, validation of the bf16 eval copy, then serving
    yolo = YOLO("yolov13n-JDE.yaml")
    reset_launches()
    t0 = time.perf_counter()
    with _timed_calls(JDETrainer, "validate", []) as val:
        metrics = yolo.train(data="synthetic", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, epochs=1,
                             seed=seed, project="runs", name="chip_smoke_amp", exist_ok=True)
    train_s = time.perf_counter() - t0
    train_by = dict(flash_area_attention.launches_by_dtype)
    steps = yolo.trainer.step
    val_batches = -(-VAL_IMAGES // TRAIN_BATCH)
    # check_bf16 runs one float32 and one bf16 forward at 64 px before the first step
    want = {"float32": LAUNCHES_PER_FORWARD,
            "bfloat16": (1 + steps + val_batches) * LAUNCHES_PER_FORWARD}
    check(yolo.trainer.model.compute_dtype == torch.bfloat16 and train_by == want
          and len(val) == 1 and val[0][1] == val_batches * LAUNCHES_PER_FORWARD,
          f"YOLO.train with amp: compute dtype {yolo.trainer.model.compute_dtype}, launches by "
          f"dtype {train_by}, expected {want}; validations {val}")
    check(all(np.isfinite(list(metrics.values()))) and "fitness" in metrics,
          f"YOLO.train with amp: metrics {metrics}")
    reset_launches()
    frames = np.random.default_rng(seed).integers(0, 256, (2, 720, 1280, 3), np.uint8)
    dets = yolo.predict_batched(frames, imgsz=TRAIN_IMGSZ, conf=1e-4)
    served = _check_bf16_launches(LAUNCHES_PER_FORWARD, "predict_batched after amp training")
    check(np.isfinite(dets).all(), "predict_batched after amp training: not finite")
    print(json.dumps({"yolo_train_amp": metrics, "seconds": train_s, "steps": steps,
                      "kernel_launches_by_dtype": train_by, "val_s": val[0][0],
                      "card": card}))
    return {f"amp train step forward @{TRAIN_IMGSZ} b{TRAIN_BATCH}": step_launches["step_forward"],
            f"remat train step (forward + recomputation) @{TRAIN_IMGSZ} b{TRAIN_BATCH}":
                step_launches["remat"],
            f"YOLO.train amp, 1 epoch ({steps} steps + validation + check_bf16)":
                train_by["bfloat16"],
            "predict_batched after amp training": served["bfloat16"]}, timing


# phase 14: the detect task on bench.py's geometry (ragged 480x640 frames, batch 128)
DETECT_SERVE = (("yolov8n.yaml", 0, (1, 8, 128)), ("yolo11n.yaml", 0, (1, 8, 128)),
                ("yolov12n.yaml", LAUNCHES_PER_FORWARD, (1, 8, 128)),
                ("yolo11n-JDE.yaml", 0, (8,)))  # (model, kernel launches a forward, batches)
DETECT_IMGSZ = 640        # bench.py's serving size
BENCH_HW = (480, 640)     # bench.py's frames
BENCH_BATCH = 128         # bench.py's serving and train_yolov8n batch
DETECT_AB_BATCH = 4       # frames of the detection A/Bs
F64_BOX_TOL = 32e-3       # px: 1e-3 of a DFL bin at stride 32, float32's floor for wide boxes
DETECT_CANDIDATES = 64    # the A/Bs' threshold leaves fewer (anchor, class) pairs a frame
MAX_LOGIT = 6.0           # the damped class logits' largest magnitude: sigmoid 0.9975


def _head_maps(out):
    """The per-level head maps of a forward (a Segment head's (maps, protos): the maps)."""
    return out[0] if isinstance(out, tuple) else out


def _damp_class_logits(yolo, frames, imgsz: int = DETECT_IMGSZ):
    """Scale the head's class-logit convolutions (weight and bias; a v10 head's two copies)
    so that the largest class logit served on `frames` is MAX_LOGIT. Perturbed weights drive
    many class scores to 1.0 in float32, where NMS orders the tied scores arbitrarily.
    Returns the gain."""
    import torch
    meta = yolo.meta
    predictor = yolo._get_predictor({"imgsz": imgsz})
    with torch.no_grad():
        maps = _head_maps(predictor.model(predictor.preprocess(frames)[0]))
        top = max(m[:, 4 * meta["reg_max"]:4 * meta["reg_max"] + meta["nc"]].abs().max().item()
                  for m in maps)
        gain = min(1.0, MAX_LOGIT / top)
        head = yolo.model.blocks[meta["head_index"]]
        for name, p in head.named_parameters():
            if name.startswith(("cv3_", "o2o_cv3_")) and "_pred." in name:
                p.mul_(gain)
    yolo._fused = yolo._half = yolo._predictor_cache = None
    return gain


def _nms_stable_conf(rows: np.ndarray, nc: int, iou_thres: float, max_cand: int,
                     margin: float = 1e-4, iou_margin: float = 1e-3):
    """A threshold at which greedy NMS keeps the same rows under rounding: above it every
    frame of `rows` (B, N, 4 + nc: decoded xywh boxes and class scores, float64) has fewer
    than `max_cand` (anchor, class) candidates; no two candidates of a class overlap by an
    IoU within `iou_margin` of `iou_thres` or, overlapping beyond it, score within `margin`
    of each other; and no score lies within `margin` of the threshold. Returns (threshold,
    half its gap)."""
    level = -np.inf
    for r in rows:
        s = r[:, 4:4 + nc]
        flat = np.sort(s.ravel())
        level = max(level, flat[-max_cand])
        anchor, cls = np.nonzero(s > flat[-max_cand])
        xy, wh = r[anchor, :2], r[anchor, 2:4]
        lo, hi = xy - wh / 2, xy + wh / 2
        inter = np.clip(np.minimum(hi[:, None], hi[None]) - np.maximum(lo[:, None], lo[None]),
                        0, None).prod(-1)
        area = wh.prod(-1)
        iou = inter / (area[:, None] + area[None] - inter)
        sc = s[anchor, cls]
        same = (cls[:, None] == cls[None]) & ~np.eye(len(cls), dtype=bool)
        close = same & ((np.abs(iou - iou_thres) < iou_margin)
                        | ((iou > iou_thres) & (np.abs(sc[:, None] - sc[None]) < margin)))
        if close.any():  # the threshold must drop the lower of each such pair
            level = max(level, np.minimum(sc[:, None], sc[None])[close].max())
    above = np.unique(rows[..., 4:4 + nc][rows[..., 4:4 + nc] > level])
    check(len(above) >= 2, f"under 2 scores above {level}")
    gaps = np.diff(above)
    wide = np.flatnonzero(gaps > 2 * margin)
    j = int(wide[0]) if len(wide) else int(gaps.argmax())
    return float((above[j] + above[j + 1]) / 2), float(gaps[j] / 2)


def _detect_model(name: str, n_frames: int, seed: int = 3):
    """Phase 14's served model and frames, which `tools/torch_port_profile.py --phase14`
    profiles: `name` with seeded, perturbed weights, its class logits damped on the first
    DETECT_AB_BATCH frames, and `n_frames` ragged 480x640 uint8 frames (the same first
    frames whatever their number). Returns (yolo, frames, gain)."""
    yolo = _perturbed_yolo(name, seed, DETECT_IMGSZ)
    frames = np.random.default_rng(seed).integers(
        0, 256, (max(n_frames, DETECT_AB_BATCH), *BENCH_HW, 3), np.uint8)
    gain = _damp_class_logits(yolo, frames[:DETECT_AB_BATCH])
    return yolo, frames[:n_frames], gain


def _candidate_summary(counts: list) -> dict:
    """min, median and max of NMS's candidates a frame, and the frames at its pre_topk."""
    return {"min": min(counts), "median": statistics.median(counts), "max": max(counts),
            "frames_at_pre_topk": sum(c >= PRE_TOPK for c in counts)}


def _float64_copy(yolo):
    """A copy of `yolo` that serves its BN-folded model in float64 (attention on the plain
    path: the kernel has no float64 variant)."""
    from sar_yolo_tpu_torch.nn.fuse import fuse_model
    exact = copy.deepcopy(yolo)
    _set_flash(exact, False)
    exact._fused = fuse_model(copy.deepcopy(exact.model)).double().eval()
    exact._half, exact._predictor_cache = None, None
    return exact


def phase_detect_serve(name: str, launches: int, batches, card: str, seed: int = 3) -> dict:
    """Serve `name` at 640 on ragged 480x640 frames (see the module docstring, phase 14);
    returns its kernel launches by path and dtype."""
    import torch

    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention, reset_launches
    yolo, frames, gain = _detect_model(name, max(batches), seed)
    meta, n_emb = yolo.meta, yolo.meta.get("embed_dim") or 0
    ab = frames[:max(DETECT_AB_BATCH, min(batches))]
    plain = copy.deepcopy(yolo)
    _set_flash(plain, False)
    exact = _float64_copy(yolo)
    yolo.predict_batched(frames[:1], imgsz=DETECT_IMGSZ, half=True)  # warm-up: fold, cast
    # frame by frame, each at a threshold where NMS's choices do not hang on rounding
    predictor = yolo._get_predictor({"imgsz": DETECT_IMGSZ})
    confs = []
    for i in range(len(ab)):
        with torch.no_grad():
            rows, _ = predictor.decode(predictor.model(predictor.preprocess(ab[i:i + 1])[0]))
        confs.append(_nms_stable_conf(rows.double().cpu().numpy(), meta["nc"], 0.7,
                                      DETECT_CANDIDATES)[0])
    out = {"got": [], "half": [], "plain": [], "f64": []}
    reset_launches()
    for i, conf in enumerate(confs):
        kw = dict(imgsz=DETECT_IMGSZ, conf=conf)
        for key, m, args in (("got", yolo, kw), ("half", yolo, {**kw, "half": True}),
                             ("plain", plain, kw), ("f64", exact, kw)):
            out[key].append(m.predict_batched(ab[i:i + 1], **args))
        plain.predict_batched(ab[i:i + 1], **kw, half=True)
    by = dict(flash_area_attention.launches_by_dtype)
    check(by == {"float32": launches * len(ab), "bfloat16": launches * len(ab)},
          f"{name}: kernel launches by dtype {by} in {len(ab)} forwards of each precision, "
          f"expected {launches} a forward (use_flash=False launches none)")
    got, got_half, want, want64 = (np.concatenate(out[k]) for k in ("got", "half", "plain", "f64"))
    n_rows = 6 + n_emb + (meta.get("state_classes") or 0)
    check(got.shape == got_half.shape == (len(ab), 300, n_rows) and np.isfinite(got_half).all(),
          f"{name}: detections of shape {got.shape}, half {got_half.shape}")
    kept, errs = _compare_detections(got, want, n_emb, f"{name} kernel vs plain")
    kept64, errs64 = _compare_detections(got, want64, n_emb, f"{name} float32 vs float64")
    x, _, _ = predictor.preprocess(ab)
    maps = _maps_errors(yolo, plain, x, min(confs), exact=exact._fused)
    xh, _, _ = yolo._get_predictor({"imgsz": DETECT_IMGSZ, "half": True}).preprocess(ab)
    maps_half = _maps_vs_f32(yolo._fused_for_serving(True), plain._fused_for_serving(True),
                             plain._fused_for_serving(), xh, x)
    # rates at bench.py's threshold, NMS's candidates a frame there beside them (decode and
    # NMS cost what they cost at that count: tools/torch_port_profile.py --phase14 splits it)
    kw, hkw = dict(imgsz=DETECT_IMGSZ, conf=0.25), dict(imgsz=DETECT_IMGSZ, conf=0.25, half=True)
    del plain, exact
    torch.cuda.empty_cache()
    rates = {}
    for b in batches:
        r = _rates(lambda: _img_per_s(yolo, frames[:b], kw, n=3),
                   lambda: _img_per_s(yolo, frames[:b], hkw, n=3))
        rates.update({f"img_per_s_b{b}_{k}": v for k, v in r.items()})
    big = max(batches)
    memory, candidates = {}, {}
    for label, args in (("f32", kw), ("bf16", hkw)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        yolo.predict_batched(frames[:big], **args)
        memory[f"max_memory_allocated_gib_b{big}_{label}"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
        p = yolo._get_predictor(args)
        with torch.no_grad():
            candidates[f"candidates_per_frame_b{big}_{label}"] = _candidate_summary(
                _candidates(p, p.model(p.preprocess(frames[:big])[0]), 0.25))
    print(json.dumps({"serve_detect": name, "task": yolo.task, "nc": meta["nc"],
                      "imgsz": DETECT_IMGSZ,
                      "frames": f"{BENCH_HW[0]}x{BENCH_HW[1]}", "ab_frames": len(ab),
                      "ab_confs": confs, "class_logit_gain": gain, "rates_conf": 0.25,
                      "kernel_launches_f32": launches,
                      "kernel_launches_bf16": launches, "kept_per_frame": kept,
                      "kept_per_frame_f64": kept64, "kept_per_frame_bf16":
                      (got_half[..., 4] > 0).sum(1).tolist(), **errs,
                      **{f"{k}_vs_f64": v for k, v in errs64.items()}, **maps, **maps_half,
                      **rates, **memory, **candidates, "card": card}))
    check(max(maps["candidates_per_frame"]) < PRE_TOPK, f"{name}: over {PRE_TOPK} candidates")
    # boxes hundreds of px wide: 1e-3 of a 32 px DFL bin (phase 10's bound); the head maps
    # against float64 below are the arbiter
    for key, tol in (("box_err_px", F64_BOX_TOL), ("score_err", 1e-3), ("embed_err", 1e-3)):
        check(errs[key] <= tol, f"{name} kernel vs plain: {key} {errs[key]}")
    # float32 against float64: as far as the head maps' own rounding moves them (a box side
    # is a DFL expectation times the stride, up to 32; an embedding is a map channel)
    d = maps["maps_plain_vs_f64"]
    for key, tol in (("box_err_px", max(F64_BOX_TOL, 2 * 32 * d)), ("score_err", max(1e-3, d)),
                     ("embed_err", max(1e-3, 2 * d))):
        check(errs64[key] <= tol, f"{name} float32 vs float64: {key} {errs64[key]} (head maps "
              f"{d} apart)")
    check(maps["maps_kernel_vs_f64"] <= 2 * maps["maps_plain_vs_f64"],
          f"{name}: kernel path {maps['maps_kernel_vs_f64']} from float64, plain path "
          f"{maps['maps_plain_vs_f64']}")
    check(maps_half["maps_bf16_kernel_vs_f32"] <= 2 * maps_half["maps_bf16_plain_vs_f32"],
          f"{name} half: kernel path {maps_half['maps_bf16_kernel_vs_f32']} from float32, plain "
          f"path {maps_half['maps_bf16_plain_vs_f32']}")
    label = f"{name.removesuffix('.yaml')}@{DETECT_IMGSZ}, {len(ab)} calls of batch 1"
    return {"float32": {f"serve {label}": by["float32"]},
            "bfloat16": {f"serve half {label}": by["bfloat16"]}}


def _detect_trainer(model: str, batch: int, seed: int, **kw):
    """A set-up DetectionTrainer of `model` on the synthetic set at TRAIN_IMGSZ (SGD, no
    warm-up) and its first batch."""
    from sar_yolo_tpu_torch.data.build import DataLoader
    from sar_yolo_tpu_torch.engine.trainer import DetectionTrainer
    tr = DetectionTrainer(dict(model=model, data="synthetic", imgsz=TRAIN_IMGSZ, batch=batch,
                               seed=seed, optimizer="SGD", nbs=batch, warmup_epochs=0.0, **kw))
    tr.setup()
    return tr, next(iter(DataLoader(tr.train_set, batch, seed=seed)))


def phase_detect_train(card: str, seed: int = 0) -> dict:
    """The yolov8n train step (f32 and amp, batch 16 and 128), yolov12n's train steps and a
    one-epoch `YOLO.train` of yolov8n, then its checkpoint (see the module docstring,
    phase 14). Returns the kernel launches by path and dtype."""
    import torch

    from sar_yolo_tpu_torch import YOLO
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention, reset_launches

    def trainer(model, batch, **kw):
        return _detect_trainer(model, batch, seed, **kw)

    # the loss falls on one batch (float32, cuDNN deterministic, as phase 6)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    tr, batch = trainer("yolov8n.yaml", TRAIN_BATCH, amp=False)
    check(tr.meta["task"] == "detect" and tr.loss_names == ("box", "cls", "dfl"),
          f"yolov8n trainer: task {tr.meta['task']}, losses {tr.loss_names}")
    totals = [tr.train_step(batch)[0].item() for _ in range(20)]
    print(json.dumps({"detect_train_fixed_batch_total_loss": totals, "model": "yolov8n"}))
    check(all(np.isfinite(totals)) and np.mean(totals[-3:]) < 0.98 * np.mean(totals[:3]),
          f"yolov8n: the total loss did not fall over 20 steps on one batch: {totals}")
    torch.backends.cudnn.deterministic = False
    timing = {f"f32_b{TRAIN_BATCH}": _timed_steps(tr, batch)}
    del tr
    torch.cuda.empty_cache()
    tr, _ = trainer("yolov8n.yaml", TRAIN_BATCH)
    check(tr.model.compute_dtype == torch.bfloat16, "yolov8n amp: not bf16 (check_bf16 failed?)")
    timing[f"amp_b{TRAIN_BATCH}"] = _timed_steps(tr, batch)
    del tr
    for label, kw in (("f32", {"amp": False}), ("amp", {})):
        torch.cuda.empty_cache()
        tr, big = trainer("yolov8n.yaml", BENCH_BATCH, **kw)
        timing[f"{label}_b{BENCH_BATCH}"] = _timed_steps(tr, big, n=3, warmup=2)
        del tr, big
    torch.cuda.empty_cache()
    print(json.dumps({"detect_train_step": f"yolov8n @{TRAIN_IMGSZ}, SGD, synthetic data",
                      **timing, "card": card}))

    # yolov12n: the kernel in the train step's forward, none in its backward
    steps = {}
    for label, kw in (("f32", {"amp": False}), ("amp", {})):
        tr, b = trainer("yolov12n.yaml", TRAIN_BATCH, **kw)
        reset_launches()
        items, _, lk = _train_step_parts(tr, b)
        by = dict(flash_area_attention.launches_by_dtype)
        dname = "float32" if label == "f32" else "bfloat16"
        check(lk == (LAUNCHES_PER_FORWARD, 0) and by[dname] == LAUNCHES_PER_FORWARD
              and np.isfinite(items).all(),
              f"yolov12n {label} train step: launches (forward, backward) {lk}, by dtype {by}, "
              f"items {items}")
        steps[label] = {"launches": lk, "by_dtype": by, "items": items.tolist()}
        del tr
        torch.cuda.empty_cache()
    print(json.dumps({"detect_train_yolov12n_step": steps, "card": card}))

    # YOLO.train with its detect validation (amp, the default), then the checkpoint
    yolo = YOLO("yolov8n.yaml")
    t0 = time.perf_counter()
    metrics = yolo.train(data="synthetic", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, epochs=1,
                         seed=seed, project="runs", name="chip_smoke_detect", exist_ok=True)
    train_s = time.perf_counter() - t0
    check(all(np.isfinite(list(metrics.values()))) and "metrics/mAP50(B)" in metrics
          and "train/dfl" in metrics and "train/emb" not in metrics,
          f"YOLO.train yolov8n: metrics {metrics}")
    ckpt = YOLO(yolo.ckpt_dir)
    check(ckpt.task == "detect" and ckpt.meta["nc"] == 3 and ckpt.names == yolo.names,
          f"YOLO(checkpoint): task {ckpt.task}, nc {ckpt.meta['nc']}, names {ckpt.names}")
    frames = np.random.default_rng(seed).integers(0, 256, (2, *BENCH_HW, 3), np.uint8)
    dets, dets_ckpt = (m.predict_batched(frames, imgsz=TRAIN_IMGSZ, conf=1e-3)
                       for m in (yolo, ckpt))
    check(dets.shape == (2, 300, 6) and np.isfinite(dets).all(), f"served rows {dets.shape}")
    val = ckpt.val(data="synthetic", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, project="runs",
                   name="chip_smoke_detect_val", exist_ok=True)
    check(all(np.isfinite(list(val.values()))), f"YOLO(checkpoint).val: {val}")
    print(json.dumps({"yolo_train_detect": metrics, "seconds": train_s,
                      "steps": yolo.trainer.step, "checkpoint": str(yolo.ckpt_dir),
                      "checkpoint_task": ckpt.task, "checkpoint_val": val,
                      "served_rows_kept": (dets[..., 4] > 0).sum(1).tolist(),
                      "checkpoint_rows_equal": bool(np.array_equal(dets, dets_ckpt)),
                      "card": card}))
    key = f"yolov12n train step forward @{TRAIN_IMGSZ} b{TRAIN_BATCH}"
    return {"float32": {key: steps["f32"]["launches"][0],
                        key.replace("forward", "backward"): steps["f32"]["launches"][1]},
            "bfloat16": {f"amp {key}": steps["amp"]["launches"][0],
                         f"amp {key}".replace("forward", "backward"): steps["amp"]["launches"][1]}}


def phase_detect(card: str) -> dict:
    """Phase 14: the detect models served, trained and validated; their launches by path."""
    t0 = time.perf_counter()
    out = {"float32": {}, "bfloat16": {}}
    for name, launches, batches in DETECT_SERVE:
        t1 = time.perf_counter()
        for dname, paths in phase_detect_serve(name, launches, batches, card).items():
            out[dname].update(paths)
        print(json.dumps({"detect_serve_s": {name: time.perf_counter() - t1}}))
    for dname, paths in phase_detect_train(card).items():
        out[dname].update(paths)
    print(json.dumps({"phase_detect_s": time.perf_counter() - t0}))
    return out


# phase 15: the fork's CBAM JDE configs and the facade's remaining methods
CBAM_BATCH = 8            # frames of the served CBAM batch (yolov13n-JDE_CBAM @640)
TRAIN_EVENTS = ("on_pretrain_routine_start", "on_pretrain_routine_end", "on_train_start",
                "on_train_epoch_start", "on_train_batch_start", "on_train_batch_end",
                "on_train_epoch_end", "on_fit_epoch_end", "on_train_end", "on_model_save")


def phase_cbam(card: str, seed: int = 0) -> dict:
    """Phase 15 (see the module docstring): the CBAM configs served and trained, then the
    facade. Returns the kernel launches by path and dtype."""
    import torch

    from sar_yolo_tpu_torch import YOLO
    from sar_yolo_tpu_torch.data.build import DataLoader
    from sar_yolo_tpu_torch.engine.model import Ensemble
    from sar_yolo_tpu_torch.engine.trainer import JDETrainer
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention, reset_launches
    out = {"float32": {}, "bfloat16": {}}
    t0 = time.perf_counter()
    name, p24 = "yolov13n-JDE_CBAM.yaml", "yolov13n-P24_CBAM_JDE.yaml"
    out["float32"][f"serve yolov13n-JDE_CBAM@640 b{CBAM_BATCH}"], _ = phase_serve(
        name, 640, None, 1e-3, CBAM_BATCH, seed, (1, CBAM_BATCH))
    out["bfloat16"][f"serve half yolov13n-JDE_CBAM@640 b{CBAM_BATCH}"] = phase_half(
        name, 640, 0.005, CBAM_BATCH, seed, (1, CBAM_BATCH), card)
    # at 1280 the box bound is phase 5's: 1e-3 of a 32 px DFL bin
    out["float32"]["serve yolov13n-P24_CBAM_JDE@1280 b1"], _ = phase_serve(
        p24, 1280, None, 32e-3, 1, seed + 1, (1,))
    out["bfloat16"]["serve half yolov13n-P24_CBAM_JDE@1280 b1"] = phase_half(
        p24, 1280, 0.5, 1, seed + 1, (1,), card)
    for dname, paths in phase_detect_serve("yolo11n-JDE_CBAM.yaml", 0, (CBAM_BATCH,),
                                           card).items():
        out[dname].update(paths)
    t_serve = time.perf_counter()

    # the train step: one A/B step in float32 (phase 6's) and in amp (phase 13's), then times
    base = dict(model=name, data="synthetic", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, seed=seed,
                optimizer="SGD", nbs=TRAIN_BATCH, warmup_epochs=0.0)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    train_set, _, _ = JDETrainer({**base, "amp": False}).get_dataset()
    batch = next(iter(DataLoader(train_set, TRAIN_BATCH, seed=seed)))
    tr, step_launches = _train_ab({**base, "amp": False}, [batch])
    torch.backends.cudnn.deterministic = False
    timing = {"f32": _timed_steps(tr, batch)}
    del tr
    torch.cuda.empty_cache()
    trainers, amp_batch, amp_launches = _amp_ab(base, seed, False, card)
    torch.backends.cudnn.deterministic = False
    timing["bf16"] = _timed_steps(trainers["bf16"], amp_batch)
    del trainers
    torch.cuda.empty_cache()
    print(json.dumps({"cbam_train_step": f"yolov13n-JDE_CBAM @{TRAIN_IMGSZ}, batch {TRAIN_BATCH}, "
                      "SGD", **timing, "card": card}))
    out["float32"][f"train step forward yolov13n-JDE_CBAM@{TRAIN_IMGSZ} b{TRAIN_BATCH}"] = \
        step_launches[0]
    out["bfloat16"][f"amp train step forward yolov13n-JDE_CBAM@{TRAIN_IMGSZ} b{TRAIN_BATCH}"] = \
        amp_launches["step_forward"]
    t_train = time.perf_counter()

    # the facade: YOLO.train's callbacks, save and YOLO(checkpoint), fuse, info, profile
    yolo = YOLO(name)
    seen = {e: [] for e in TRAIN_EVENTS}
    for event in TRAIN_EVENTS:
        yolo.add_callback(event, lambda trainer, event=event: seen[event].append(trainer.epoch))
    reset_launches()
    metrics = yolo.train(data="synthetic", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, epochs=1,
                         seed=seed, amp=False, project="runs", name="chip_smoke_cbam",
                         exist_ok=True)
    train_launches, steps = flash_area_attention.launches, yolo.trainer.step
    val_batches = -(-VAL_IMAGES // TRAIN_BATCH)
    want = {e: [0] * (steps if "batch" in e else 1) for e in TRAIN_EVENTS}
    check(seen == want, f"YOLO.train callbacks: epochs seen {seen}, expected {want}")
    check(train_launches == (steps + val_batches) * LAUNCHES_PER_FORWARD
          and all(np.isfinite(list(metrics.values()))),
          f"YOLO.train: {train_launches} kernel launches, metrics {metrics}")
    frames = np.random.default_rng(seed).integers(0, 256, (CBAM_BATCH, 720, 1280, 3), np.uint8)
    kw = dict(imgsz=TRAIN_IMGSZ, conf=0.001)
    reset_launches()
    before = yolo.predict_batched(frames, **kw)
    served_launches = flash_area_attention.launches
    check(served_launches == LAUNCHES_PER_FORWARD and np.isfinite(before).all()
          and (before[..., 4] > 0).any(), f"predict_batched after training: "
          f"{flash_area_attention.launches} kernel launches")
    ckpt = yolo.save(Path("runs") / "chip_smoke_cbam_saved")
    served = YOLO(ckpt).predict_batched(frames, **kw)
    check(np.array_equal(served, before), "YOLO(checkpoint of save()) serves other detections: "
          f"max diff {np.abs(served - before).max()}")
    yolo.fuse()
    check(not any(isinstance(m, torch.nn.BatchNorm2d) for m in yolo.model.modules()),
          "fuse(): a BatchNorm is left")
    fused = yolo.predict_batched(frames, **kw)
    check(np.array_equal(fused, before), "predict_batched after fuse() differs: max diff "
          f"{np.abs(fused - before).max()}")
    summary = yolo.info(detailed=True, verbose=False)
    print(summary)
    profile = yolo.profile()
    other = _perturbed_yolo(name, seed + 2, TRAIN_IMGSZ).save(Path("runs") / "chip_smoke_cbam_other")
    reset_launches()
    merged = Ensemble([ckpt, other]).predict(str(JPEG_DIR / "frames"), imgsz=TRAIN_IMGSZ,
                                             conf=0.01)
    ens_launches = flash_area_attention.launches
    check(len(merged) == JPEG_FRAMES and sum(len(m) for m in merged) > 0
          and all(np.isfinite(m).all() and m.shape[1] == 6 for m in merged) and ens_launches == 2 * JPEG_FRAMES * LAUNCHES_PER_FORWARD,
          f"Ensemble: {len(merged)} frames, rows {[m.shape for m in merged]}, {ens_launches} "
          "kernel launches")
    print(json.dumps({"cbam_facade": name, "yolo_train": metrics, "callbacks_epochs": seen,
                      "save_then_serve_equal": True, "fuse_then_serve_equal": True,
                      "kept_per_frame": (before[..., 4] > 0).sum(1).tolist(),
                      "info": summary.splitlines()[0], "profile": profile,
                      "ensemble_rows_per_frame": [len(m) for m in merged],
                      "kernel_launches": {"train": train_launches, "ensemble": ens_launches},
                      "card": card}))
    out["float32"].update({
        f"YOLO.train yolov13n-JDE_CBAM, 1 epoch ({steps} steps + validation)": train_launches,
        "predict_batched after YOLO.train of yolov13n-JDE_CBAM": served_launches,
        f"Ensemble of 2 checkpoints, {JPEG_FRAMES} JPEG frames": ens_launches})
    print(json.dumps({"phase_cbam_s": {"serve": t_serve - t0, "train_step": t_train - t_serve,
                                       "facade": time.perf_counter() - t_train}}))
    return out


# phase 16: the rest of the detect family (YOLOv10's NMS-free path; v3/v5/v6/v8-ghost/p6/v9)
FAMILY_SERVE = (("yolov9t.yaml", 640), ("yolov9e.yaml", 640), ("yolov5n.yaml", 640),
                ("yolov3-tiny.yaml", 640), ("yolov6n.yaml", 640), ("yolov8n-ghost.yaml", 640),
                ("yolov8n-p6.yaml", 1280))  # (model, imgsz): served at FAMILY_BATCH (P6: 1)
FAMILY_BATCH = 8          # frames of the family's served batches
V10_BATCHES = (1, 8, 128)  # yolov10n's rate batches (128: bench.py's)
E2E_MARGIN = 1e-4         # rows scored this near conf or the k-th score are left out
MAX_BOX_LOGIT = 10.0      # the family's damped box-regression (DFL) logits' largest magnitude


def _damp_head_logits(yolo, frames, imgsz: int, branch: str = "cv2_",
                      limit: float = MAX_BOX_LOGIT) -> float:
    """Scale the head's `branch` prediction convolutions (weight and bias) so that the largest
    logit they serve on `frames` is `limit`. The box regression ("cv2_"): deep perturbed
    models (yolov9e) reach ~500 there, where the DFL softmax is an argmax that float32
    rounding flips by a whole bin (a stride of pixels). An OBB head's angle ("cv4_", at
    MAX_LOGIT): where its sigmoid's float32 rounding moves the angle by over 1e-5 rad, a
    box's centre moves by its offset from the anchor times that. Returns the gain."""
    import torch
    meta = yolo.meta
    c0 = 4 * meta["reg_max"]
    channels = slice(0, c0) if branch == "cv2_" else slice(c0 + meta["nc"], None)
    predictor = yolo._get_predictor({"imgsz": imgsz})
    with torch.no_grad():
        maps = _head_maps(predictor.model(predictor.preprocess(frames)[0]))
        gain = min(1.0, limit / max(m[:, channels].abs().max().item() for m in maps))
        for name, p in yolo.model.blocks[meta["head_index"]].named_parameters():
            if name.startswith(branch) and "_pred." in name:
                p.mul_(gain)
    yolo._fused = yolo._half = yolo._predictor_cache = None
    return gain


def _e2e_compare(got, want, scores64, conf: float, label: str, max_det: int = 300):
    """End-to-end rows of `got` against `want` (the model in float64), both (B, max_det, 6),
    over the rows whose float64 score is not within E2E_MARGIN of `conf` or of the frame's
    max_det-th score (`scores64`: (B, N * nc) float64 class scores): their fate in the top-k
    hangs on rounding. Returns `_compare_detections`' kept counts and errors, and the rows
    left out."""
    left_out, g_kept, w_kept = [], [], []
    for b in range(len(got)):
        s = np.sort(scores64[b])[::-1]
        cuts = [conf] + ([s[max_det - 1]] if len(s) >= max_det else [])

        def keep(rows):
            far = np.ones(len(rows), bool)
            for c in cuts:
                far &= np.abs(rows[:, 4] - c) > E2E_MARGIN
            return rows[far & (rows[:, 4] > 0)]
        g, w = keep(got[b]), keep(want[b])
        left_out.append(int((got[b][:, 4] > 0).sum()) - len(g))
        g_kept.append(np.pad(g, ((0, max_det + 1 - len(g)), (0, 0))))
        w_kept.append(np.pad(w, ((0, max_det + 1 - len(w)), (0, 0))))
    kept, errs = _compare_detections(np.stack(g_kept), np.stack(w_kept), 0, label)
    return kept, errs, left_out


def _unfused_e2e(yolo, x, conf: float):
    """yolov10n's end-to-end rows from its unfused model (eval forward, decode, top-k), in
    letterboxed pixels."""
    import torch

    from sar_yolo_tpu_torch.ops.nms import postprocess_end2end
    predictor, meta = yolo._get_predictor({"imgsz": DETECT_IMGSZ}), yolo.meta
    with torch.no_grad():
        preds, _ = predictor.decode(yolo.model.eval()(x))
        return postprocess_end2end(preds, 300, conf, meta["nc"]).cpu().numpy()


def phase_v10_serve(card: str, seed: int = 3) -> dict:
    """yolov10n served end to end at 640 on phase 14's frames (see the module docstring,
    phase 16); returns its numbers."""
    import torch

    from sar_yolo_tpu_torch.ops.nms import non_max_suppression, postprocess_end2end
    name = "yolov10n.yaml"
    yolo, frames, gain = _detect_model(name, max(V10_BATCHES), seed)
    meta, nc = yolo.meta, yolo.meta["nc"]
    check(meta["head"] == "v10Detect" and yolo.task == "detect", f"{name}: meta {meta['head']}")
    ab = frames[:DETECT_AB_BATCH]
    exact = _float64_copy(yolo)
    predictor = yolo._get_predictor({"imgsz": DETECT_IMGSZ})
    x, r, pad = predictor.preprocess(ab)
    with torch.no_grad():
        preds64, _ = exact._get_predictor({"imgsz": DETECT_IMGSZ}).decode(
            exact._fused_for_serving()(x.double()))
        maps, ref = yolo._fused_for_serving()(x), exact._fused_for_serving()(x.double())
    scores64 = preds64[..., 4:4 + nc].flatten(1).cpu().numpy()
    # the comparison's threshold: every frame keeps at least 50 rows (bench.py's 0.25 may
    # leave none on these damped weights; the rates below use it)
    conf = float(np.sort(scores64, 1)[:, -50].min())
    kw, hkw = dict(imgsz=DETECT_IMGSZ, conf=conf), dict(imgsz=DETECT_IMGSZ, conf=conf, half=True)
    got = yolo.predict_batched(ab, **kw)
    want = exact.predict_batched(ab, **kw)
    half = yolo.predict_batched(ab, **hkw)
    check(got.shape == half.shape == (len(ab), 300, 6) and np.isfinite(half).all(),
          f"{name}: rows {got.shape}, half {half.shape}")
    kept, errs, left_out = _e2e_compare(got, want, scores64, conf, f"{name} float32 vs float64")
    d = max((m.double() - q).abs().max().item() for m, q in zip(maps, ref))
    for key, tol in (("box_err_px", max(F64_BOX_TOL, 2 * 32 * d)), ("score_err", max(1e-3, d))):
        check(errs[key] <= tol, f"{name} float32 vs float64: {key} {errs[key]} (maps {d} apart)")
    # fuse(): the folded model (RepVGGDW merged) serves the unfused model's rows
    folded = copy.deepcopy(yolo).fuse()
    check(folded.fused and not any(isinstance(m, torch.nn.BatchNorm2d)
                                   for m in folded.model.modules()), f"{name}: fuse() left a BN")
    fused_rows = folded.predict_batched(ab, **kw)
    unfused = _unfused_e2e(yolo, x, conf)
    unfused[..., :4] = (unfused[..., :4] - np.array([*pad, *pad], np.float32)) / r
    kept_f, errs_f, _ = _e2e_compare(fused_rows, unfused, scores64, conf, f"{name} fuse()")
    with torch.no_grad():  # two float32 roundings of the same maps: folded and unfolded
        d_fu = max((m - q).abs().max().item() for m, q in zip(folded.model(x), yolo.model(x)))
    check(d_fu <= 4 * d, f"{name}: fuse() maps {d_fu} from the unfused model's, float32's "
          f"floor {d}")
    for key, tol in (("box_err_px", max(F64_BOX_TOL, 2 * 32 * d_fu)),
                     ("score_err", max(1e-3, d_fu))):
        check(errs_f[key] <= tol, f"{name} fuse() vs unfused: {key} {errs_f[key]} (maps "
              f"{d_fu} apart)")
    del folded, exact
    torch.cuda.empty_cache()
    # rates at bench.py's conf 0.25, f32 and bf16 in turns; peak memory at 128
    kw, hkw = dict(imgsz=DETECT_IMGSZ, conf=0.25), dict(imgsz=DETECT_IMGSZ, conf=0.25, half=True)
    rates = {}
    for b in V10_BATCHES:
        r = _rates(lambda: _img_per_s(yolo, frames[:b], kw, n=3),
                   lambda: _img_per_s(yolo, frames[:b], hkw, n=3))
        rates.update({f"img_per_s_b{b}_{k}": v for k, v in r.items()})
    big = max(V10_BATCHES)
    memory = {}
    for label, args in (("f32", kw), ("bf16", hkw)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        yolo.predict_batched(frames[:big], **args)
        memory[f"max_memory_allocated_gib_b{big}_{label}"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
    # decode + the NMS-free top-k against decode + greedy NMS, on the same maps of 128 frames
    with torch.no_grad():
        feats = predictor.model(predictor.preprocess(frames[:big])[0])

        def e2e():
            return postprocess_end2end(predictor.decode(feats)[0], 300, 0.25, nc)

        def nms():
            return non_max_suppression(predictor.decode(feats)[0], conf_thres=0.25,
                                       iou_thres=0.7, max_det=300, nc=nc)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a host sync in the top-k path raises
        try:
            e2e()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        post = {f"decode_end2end_ms_b{big}": event_ms(e2e, iters=10),
                f"decode_nms_ms_b{big}": event_ms(nms, iters=10),
                f"nms_candidates_per_frame_b{big}": _candidate_summary(
                    _candidates(predictor, feats, 0.25))}
    print(json.dumps({"serve_v10": name, "imgsz": DETECT_IMGSZ,
                      "frames": f"{BENCH_HW[0]}x{BENCH_HW[1]}", "ab_frames": len(ab),
                      "conf": conf, "rates_conf": 0.25, "class_logit_gain": gain, "kept_per_frame": kept,
                      "rows_left_out_per_frame": left_out, **errs, "maps_f32_vs_f64": d,
                      "kept_per_frame_half": (half[..., 4] > 0).sum(1).tolist(),
                      "fuse_kept_per_frame": kept_f, "fuse_maps_vs_unfused": d_fu,
                      **{f"fuse_{k}": v for k, v in errs_f.items()}, **rates, **memory, **post,
                      "card": card}))
    return {"rates": rates, **post}


def phase_v10_train(card: str, seed: int = 0) -> dict:
    """The yolov10n train step, `YOLO.train` and its checkpoint (see the module docstring,
    phase 16)."""
    import torch

    from sar_yolo_tpu_torch import YOLO
    name = "yolov10n.yaml"
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    tr, batch = _detect_trainer(name, TRAIN_BATCH, seed, amp=False)
    check(tr.meta["head"] == "v10Detect" and tr.loss_names == ("box", "cls", "dfl"),
          f"{name} trainer: head {tr.meta['head']}, losses {tr.loss_names}")
    totals = [tr.train_step(batch)[0].item() for _ in range(20)]
    print(json.dumps({"v10_train_fixed_batch_total_loss": totals, "model": name}))
    check(all(np.isfinite(totals)) and np.mean(totals[-3:]) < 0.98 * np.mean(totals[:3]),
          f"{name}: the total loss did not fall over 20 steps on one batch: {totals}")
    torch.backends.cudnn.deterministic = False
    timing = {f"f32_b{TRAIN_BATCH}": _timed_steps(tr, batch)}
    del tr
    torch.cuda.empty_cache()
    tr, _ = _detect_trainer(name, TRAIN_BATCH, seed)
    check(tr.model.compute_dtype == torch.bfloat16, f"{name} amp: not bf16 (check_bf16 failed?)")
    timing[f"amp_b{TRAIN_BATCH}"] = _timed_steps(tr, batch)
    del tr
    torch.cuda.empty_cache()
    yolo = YOLO(name)
    t0 = time.perf_counter()
    metrics = yolo.train(data="synthetic", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, epochs=1,
                         seed=seed, project="runs", name="chip_smoke_v10", exist_ok=True)
    train_s = time.perf_counter() - t0
    check(all(np.isfinite(list(metrics.values()))) and "metrics/mAP50(B)" in metrics
          and "train/dfl" in metrics, f"YOLO.train {name}: metrics {metrics}")
    ckpt = YOLO(yolo.ckpt_dir)
    check(ckpt.task == "detect" and ckpt.meta["head"] == "v10Detect" and ckpt.meta["nc"] == 3
          and ckpt.names == yolo.names,
          f"YOLO(checkpoint): task {ckpt.task}, head {ckpt.meta['head']}, nc {ckpt.meta['nc']}")
    frames = np.random.default_rng(seed).integers(0, 256, (2, *BENCH_HW, 3), np.uint8)
    dets, dets_ckpt = (m.predict_batched(frames, imgsz=TRAIN_IMGSZ, conf=1e-3)
                       for m in (yolo, ckpt))
    check(dets.shape == (2, 300, 6) and np.isfinite(dets).all(), f"served rows {dets.shape}")
    val = ckpt.val(data="synthetic", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, project="runs",
                   name="chip_smoke_v10_val", exist_ok=True)
    check(all(np.isfinite(list(val.values()))), f"YOLO(checkpoint).val: {val}")
    print(json.dumps({"v10_train_step": f"{name} @{TRAIN_IMGSZ}, SGD, synthetic data",
                      **timing, "yolo_train": metrics, "seconds": train_s,
                      "steps": yolo.trainer.step, "checkpoint_task": ckpt.task,
                      "checkpoint_val": val,
                      "served_rows_kept": (dets[..., 4] > 0).sum(1).tolist(),
                      "checkpoint_rows_equal": bool(np.array_equal(dets, dets_ckpt)),
                      "card": card}))
    return timing


def phase_family_serve(name: str, imgsz: int, card: str, seed: int = 3) -> dict:
    """`name` served BN-folded at `imgsz` (see the module docstring, phase 16): its rows
    against float64 frame by frame at `_nms_stable_conf` thresholds, img/s in f32 and bf16."""
    import torch
    batch = 1 if imgsz > DETECT_IMGSZ else FAMILY_BATCH
    hw = (720, 1280) if imgsz > DETECT_IMGSZ else BENCH_HW
    yolo = _perturbed_yolo(name, seed, imgsz)
    frames = np.random.default_rng(seed).integers(0, 256, (max(batch, 2), *hw, 3), np.uint8)
    meta = yolo.meta
    gain = _damp_class_logits(yolo, frames[:2], imgsz)
    box_gain = _damp_head_logits(yolo, frames[:2], imgsz)
    exact = _float64_copy(yolo)
    predictor = yolo._get_predictor({"imgsz": imgsz})
    confs, got, want = [], [], []
    for i in range(2):
        with torch.no_grad():
            rows, _ = exact._get_predictor({"imgsz": imgsz}).decode(
                exact._fused_for_serving()(predictor.preprocess(frames[i:i + 1])[0].double()))
        confs.append(_nms_stable_conf(rows.cpu().numpy(), meta["nc"], 0.7, DETECT_CANDIDATES)[0])
        got.append(yolo.predict_batched(frames[i:i + 1], imgsz=imgsz, conf=confs[-1]))
        want.append(exact.predict_batched(frames[i:i + 1], imgsz=imgsz, conf=confs[-1]))
    got, want = np.concatenate(got), np.concatenate(want)
    kept, errs = _compare_detections(got, want, 0, f"{name} float32 vs float64")
    x, r, _ = predictor.preprocess(frames[:2])
    with torch.no_grad():
        d = max((m.double() - q).abs().max().item() for m, q in
                zip(yolo._fused_for_serving()(x), exact._fused_for_serving()(x.double())))
    # a box side is a DFL expectation times the stride (64 at P6), in frame pixels over r
    box_tol = max(F64_BOX_TOL, 2 * max(meta["strides"]) * d) / r
    for key, tol in (("box_err_px", box_tol), ("score_err", max(1e-3, d))):
        check(errs[key] <= tol, f"{name} float32 vs float64: {key} {errs[key]} (maps {d} apart)")
    del exact
    kw, hkw = dict(imgsz=imgsz, conf=0.25), dict(imgsz=imgsz, conf=0.25, half=True)
    half = yolo.predict_batched(frames[:batch], **hkw)
    check(half.shape == (batch, 300, 6) and np.isfinite(half).all(), f"{name} half: {half.shape}")
    r = _rates(lambda: _img_per_s(yolo, frames[:batch], kw, n=3),
               lambda: _img_per_s(yolo, frames[:batch], hkw, n=3))
    out = {"serve_family": name, "imgsz": imgsz, "batch": batch, "frames": f"{hw[0]}x{hw[1]}",
           "params": sum(p.numel() for p in yolo.model.parameters()), "confs": confs,
           "class_logit_gain": gain, "box_logit_gain": box_gain, "kept_per_frame": kept,
           **errs, "maps_f32_vs_f64": d,
           **{f"img_per_s_b{batch}_{k}": v for k, v in r.items()}, "card": card}
    print(json.dumps(out))
    torch.cuda.empty_cache()
    return out


def phase_detect_family(card: str) -> dict:
    """Phase 16: yolov10n's NMS-free path served, fused, trained and validated, and the v3,
    v5, v6, v8-ghost, v8-p6 and v9 configs served; none runs the attention kernel. Returns
    the launches by path."""
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention, reset_launches
    t0 = time.perf_counter()
    reset_launches()
    phase_v10_serve(card)
    t_serve = time.perf_counter()
    phase_v10_train(card)
    t_train = time.perf_counter()
    for name, imgsz in FAMILY_SERVE:
        phase_family_serve(name, imgsz, card)
    by = dict(flash_area_attention.launches_by_dtype)
    check(by == {"float32": 0, "bfloat16": 0}, f"phase 16: attention kernel launches {by}")
    print(json.dumps({"phase_detect_family_s": {"v10_serve": t_serve - t0,
                                                "v10_train": t_train - t_serve,
                                                "family_serve": time.perf_counter() - t_train},
                      "kernel_launches_by_dtype": by}))
    paths = {f"serve yolov10n@{DETECT_IMGSZ} end2end, f32 and bf16": 0,
             f"yolov10n train step @{TRAIN_IMGSZ} b{TRAIN_BATCH}, f32 and amp": 0,
             "YOLO.train yolov10n, 1 epoch + end2end validation": 0,
             **{f"serve {n.removesuffix('.yaml')}@{s}, f32 and bf16": 0 for n, s in FAMILY_SERVE}}
    return paths


# phase 17: the pose and segment tasks (no A2C2f block in any of their graphs)
POSE_SEG_SERVE = (("yolov8n-pose.yaml", (1, 8, 128)), ("yolov8n-seg.yaml", (1, 8)),
                  ("yolo11n-pose.yaml", (FAMILY_BATCH,)), ("yolo11n-seg.yaml", (FAMILY_BATCH,)),
                  ("yolov9c-seg.yaml", (FAMILY_BATCH,)))  # (model, rate batches)
COCO_FLIP_IDX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]
POSE_SEG_TRAIN, POSE_SEG_VAL = 16, 8   # frames of phase 17's datasets, 720x1280
MASK_MARGIN = 1e-4        # mask pixels whose float64 probability is this near 0.5 are left out
VIS_TOL = 1e-5            # keypoint visibility against float64 (or the maps' own distance)


def _write_pose_seg_dataset(root: Path, task: str, seed: int) -> dict:
    """A pose (17 keypoints, COCO's flip_idx) or segment (polygons of 6-12 vertices, two
    classes) dataset of PNG frames at 720x1280 under `root`, terrain as phase 8's, 1-12
    instances of 20-120 px a frame drawn into the pixels. Returns the dataset dict."""
    from sar_yolo_tpu_torch.data.cv import fill_poly
    rng = np.random.default_rng(seed)
    h, w = 720, 1280
    for split, n in (("train", POSE_SEG_TRAIN), ("val", POSE_SEG_VAL)):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            cells = rng.integers(40, 200, (h // 80 + 1, w // 80 + 1, 3), np.uint8)
            img = np.repeat(np.repeat(cells, 80, 0), 80, 1)[:h, :w]
            img = (img + rng.integers(0, 24, (h, w, 3), np.uint8)).astype(np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 13))):
                bw, bh = (int(v) for v in rng.integers(20, 121, 2))
                x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
                colour = rng.integers(0, 256, 3, np.uint8)
                if task == "pose":
                    img[y1:y1 + bh, x1:x1 + bw] = colour
                    k = np.stack([rng.uniform(x1, x1 + bw, 17) / w, rng.uniform(y1, y1 + bh, 17) / h,
                                  rng.integers(0, 3, 17)], 1)
                    rows.append(f"0 {(x1 + bw / 2) / w:.6f} {(y1 + bh / 2) / h:.6f} {bw / w:.6f} "
                                f"{bh / h:.6f} " + " ".join(f"{v:.6f}" for v in k.ravel()))
                else:
                    m = int(rng.integers(6, 13))
                    ang = np.sort(rng.uniform(0, 2 * np.pi, m))
                    rad = rng.uniform(0.5, 1.0, m)
                    poly = np.stack([x1 + bw / 2 * (1 + rad * np.cos(ang)),
                                     y1 + bh / 2 * (1 + rad * np.sin(ang))], 1)
                    inside = fill_poly(np.zeros((h, w), np.uint8), np.round(poly).astype(np.int32), 1)
                    img[inside > 0] = colour
                    rows.append(f"{int(rng.integers(0, 2))} " +
                                " ".join(f"{v:.6f}" for v in (poly / [w, h]).ravel()))
            (root / "images" / split / f"{i:04d}.png").write_bytes(_png_file(img))
            (root / "labels" / split / f"{i:04d}.txt").write_text("\n".join(rows) + "\n")
    data = {"path": str(root.resolve()), "train": "images/train", "val": "images/val"}
    if task == "pose":
        return {**data, "names": {0: "person"}, "kpt_shape": [17, 3], "flip_idx": COCO_FLIP_IDX}
    return {**data, "names": {0: "person", 1: "vehicle"}}


def _paired_rows(g, w):
    """The kept rows of one frame, `w`'s reordered to pair `g`'s by class and box."""
    g, w = g[g[:, 4] > 0], w[w[:, 4] > 0]
    match = (np.abs(g[:, None, :4] - w[None, :, :4]).max(-1)
             + 1e9 * (g[:, None, 5] != w[None, :, 5])).argmin(1)
    return g, w[match], match


def _mask_mismatches(masks, rows64, logit32, logit64, box_err: float, H: int) -> dict:
    """The served masks (k, mh, mw) against float64's (logit64 > 0, cropped) where no rounding
    decides: a pixel is undecided where float64's probability lies within MASK_MARGIN of 0.5
    or its logit within the largest float32 - float64 logit distance (logit32: the served
    path's own mask logits of the same rows) of 0, or where it lies within the boxes' float32
    error of a crop edge (at mask scale). `rows64`, `logit64`: float64's paired to the masks.
    Returns the mismatched and undecided pixel counts and that distance."""
    mh, mw = masks.shape[1:]
    dist = float(np.abs(logit32 - logit64).max()) if len(masks) else 0.0
    scale = np.array([mw / H, mh / H, mw / H, mh / H])
    edges = rows64[:, :4] * scale
    tol = 2 * box_err * mw / H + 1e-6
    c, r = np.arange(mw)[None, None, :], np.arange(mh)[None, :, None]
    near_edge = ((np.abs(c - edges[:, None, None, 0]) <= tol) | (np.abs(c - edges[:, None, None, 2]) <= tol)
                 | (np.abs(r - edges[:, None, None, 1]) <= tol) | (np.abs(r - edges[:, None, None, 3]) <= tol))
    inside = ((c >= edges[:, None, None, 0]) & (c < edges[:, None, None, 2])
              & (r >= edges[:, None, None, 1]) & (r < edges[:, None, None, 3]))
    undecided = (np.abs(logit64) <= max(4 * MASK_MARGIN, dist)) | near_edge
    ref = (logit64 > 0) & inside
    return {"mismatched": int(((masks != ref) & ~undecided).sum()),
            "undecided": int(undecided.sum()), "logit_f32_vs_f64": dist}


def phase_pose_seg_serve(name: str, batches, card: str, seed: int = 3) -> dict:
    """`name` served at 640 on phase 14's ragged 480x640 frames (see the module docstring,
    phase 17): rows (and keypoints or masks) against float64, half, fuse(), img/s."""
    import torch
    yolo, frames, gain = _detect_model(name, max(max(batches), 2), seed)
    meta, task = yolo.meta, yolo.task
    box_gain = _damp_head_logits(yolo, frames[:2], DETECT_IMGSZ)
    ab = frames[:2]
    exact = _float64_copy(yolo)
    predictor = yolo._get_predictor({"imgsz": DETECT_IMGSZ})
    p64 = exact._get_predictor({"imgsz": DETECT_IMGSZ})
    x, r, pad = predictor.preprocess(ab)
    check(r == 1.0, f"{name}: 480x640 frames at 640 letterbox with r {r}")
    with torch.no_grad():
        out, out64 = yolo._fused_for_serving()(x), exact._fused_for_serving()(x.double())
    d = max((m.double() - q).abs().max().item()
            for m, q in zip(_head_maps(out), _head_maps(out64)))
    confs, got, want, half, f64_full = [], [], [], [], []
    for i in range(len(ab)):
        with torch.no_grad():
            o64 = exact._fused_for_serving()(x[i:i + 1].double())
            rows, _ = p64.decode(_head_maps(o64))
            conf = _nms_stable_conf(rows.cpu().numpy(), meta["nc"], 0.7, DETECT_CANDIDATES)[0]
        confs.append(conf)
        kw = dict(imgsz=DETECT_IMGSZ, conf=conf)
        got.append(yolo.predict_batched(ab[i:i + 1], **kw))
        want.append(exact.predict_batched(ab[i:i + 1], **kw))
        half.append(yolo.predict_batched(ab[i:i + 1], **kw, half=True))
        if task == "segment":  # both paths' letterbox rows with coefficients, and mask logits
            logits = []
            for pr, o in ((predictor, yolo._fused_for_serving()(x[i:i + 1])), (p64, o64)):
                conf0, pr.args.conf = pr.args.conf, conf
                with torch.no_grad():
                    full = pr.decode_nms(o[0])
                    logits.append(torch.einsum("bnc,bchw->bnhw", full[..., 6:].float() if pr is
                                               predictor else full[..., 6:], o[1].to(full.dtype)
                                               if pr is predictor else o[1])[0].double().cpu().numpy())
                pr.args.conf = conf0
            f64_full.append((full[0].cpu().numpy(), *logits))
    out_json = {"serve_pose_seg": name, "task": task, "nc": meta["nc"], "imgsz": DETECT_IMGSZ,
                "frames": f"{BENCH_HW[0]}x{BENCH_HW[1]}", "confs": confs,
                "class_logit_gain": gain, "box_logit_gain": box_gain, "maps_f32_vs_f64": d}
    box_tol, score_tol = max(F64_BOX_TOL, 2 * 32 * d), max(1e-3, d)
    kept, errs = [], {"box_err_px": 0.0, "score_err": 0.0}
    if task == "pose":
        K, D = meta["kpt_shape"]
        xy = np.r_[[6 + D * k + j for k in range(K) for j in (0, 1)]]
        vis = np.r_[[6 + D * k + 2 for k in range(K)]] if D == 3 else np.r_[[]].astype(int)
        errs.update(kpt_xy_err_px=0.0, kpt_vis_err=0.0)
        for g, w, h in zip(got, want, half):
            check(g.shape == h.shape == (1, 300, 6 + K * D) and np.isfinite(h).all(),
                  f"{name}: rows {g.shape}, half {h.shape}")
            k_, e_ = _compare_detections(g[..., :6], w[..., :6], 0, f"{name} float32 vs float64")
            kept += k_
            gg, ww, _ = _paired_rows(g[0], w[0])
            errs["box_err_px"] = max(errs["box_err_px"], e_["box_err_px"])
            errs["score_err"] = max(errs["score_err"], e_["score_err"])
            errs["kpt_xy_err_px"] = max(errs["kpt_xy_err_px"],
                                        float(np.abs(gg[:, xy] - ww[:, xy]).max()))
            if len(vis):
                errs["kpt_vis_err"] = max(errs["kpt_vis_err"],
                                          float(np.abs(gg[:, vis] - ww[:, vis]).max()))
        check(errs["kpt_xy_err_px"] <= box_tol and errs["kpt_vis_err"] <= max(VIS_TOL, d),
              f"{name} float32 vs float64: keypoints {errs} (maps {d} apart)")
    else:
        mism, undecided, dist = 0, 0, 0.0
        for (g, gm), (w, _), (h, hm), (full, logit32, logit64) in zip(got, want, half, f64_full):
            check(g.shape == h.shape == (1, 300, 6) and gm.shape == hm.shape and gm.dtype == bool
                  and np.isfinite(h).all(), f"{name}: rows {g.shape}, masks {gm.shape}")
            k_, e_ = _compare_detections(g, w, 0, f"{name} float32 vs float64")
            kept += k_
            errs["box_err_px"] = max(errs["box_err_px"], e_["box_err_px"])
            errs["score_err"] = max(errs["score_err"], e_["score_err"])
            # the masks against float64's probabilities, pairing the letterbox rows
            pad4 = np.array([*pad, *pad])
            check(np.allclose(full[:, :4] - pad4, w[0][:, :4], atol=1e-6) and
                  np.array_equal(full[:, 4:6], w[0][:, 4:6]), f"{name}: float64 rows")
            n = int((g[0][:, 4] > 0).sum())
            _, _, match = _paired_rows(g[0], w[0])
            mm = _mask_mismatches(gm[0][:n], full[match], logit32[:n], logit64[match],
                                  e_["box_err_px"], DETECT_IMGSZ)
            mism, undecided = mism + mm["mismatched"], undecided + mm["undecided"]
            dist = max(dist, mm["logit_f32_vs_f64"])
        errs.update(mask_pixels_mismatched=mism, mask_pixels_undecided=undecided,
                    mask_pixels_compared=sum(int((g[0][:, 4] > 0).sum()) for g, _ in got)
                    * int(np.prod(got[0][1].shape[2:])) - undecided,
                    mask_logit_f32_vs_f64=dist, mask_shape=list(got[0][1].shape[2:]))
        check(mism == 0, f"{name}: {mism} mask pixels differ from float64 where no rounding "
              f"decides ({undecided} left out)")
    for key, tol in (("box_err_px", box_tol), ("score_err", score_tol)):
        check(errs[key] <= tol, f"{name} float32 vs float64: {key} {errs[key]} (maps {d} apart)")
    del exact
    # fuse(): the folded model serves the rows (and masks) of the serving copy
    folded = copy.deepcopy(yolo).fuse()
    check(not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.model.modules()),
          f"{name}: fuse() left a BN")
    kw = dict(imgsz=DETECT_IMGSZ, conf=confs[0])
    a, b = folded.predict_batched(ab[:1], **kw), yolo.predict_batched(ab[:1], **kw)
    same = all(np.array_equal(u, v) for u, v in zip(a, b)) if task == "segment" else \
        np.array_equal(a, b)
    check(same, f"{name}: fuse() serves other rows than the BN-folded serving copy")
    del folded
    torch.cuda.empty_cache()
    kw, hkw = dict(imgsz=DETECT_IMGSZ, conf=0.25), dict(imgsz=DETECT_IMGSZ, conf=0.25, half=True)
    rates = {}
    for bsz in batches:
        rr = _rates(lambda: _img_per_s(yolo, frames[:bsz], kw, n=3),
                    lambda: _img_per_s(yolo, frames[:bsz], hkw, n=3))
        rates.update({f"img_per_s_b{bsz}_{k}": v for k, v in rr.items()})
    big = max(batches)
    memory = {}
    for label, args in (("f32", kw), ("bf16", hkw)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = yolo.predict_batched(frames[:big], **args)
        memory[f"max_memory_allocated_gib_b{big}_{label}"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
    if task == "segment":
        memory["bytes_to_host_b" + str(big)] = {"rows": int(res[0].nbytes), "masks": int(res[1].nbytes)}
    out_json.update(kept_per_frame=kept, **errs, **rates, **memory, card=card)
    print(json.dumps(out_json))
    torch.cuda.empty_cache()
    return out_json


def _pose_seg_trainer(task: str, data: dict, seed: int, **kw):
    """A set-up PoseTrainer / SegmentTrainer of yolov8n-pose / -seg on `data` at TRAIN_IMGSZ
    (SGD, no warm-up) and its first batch."""
    from sar_yolo_tpu_torch.engine.trainer import TRAINERS
    name = {"pose": "yolov8n-pose.yaml", "segment": "yolov8n-seg.yaml"}[task]
    tr = TRAINERS[task](dict(model=name, data=data, imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, seed=seed,
                             optimizer="SGD", nbs=TRAIN_BATCH, warmup_epochs=0.0, workers=8,
                             project="runs", name=f"chip_smoke_{task}", exist_ok=True, **kw))
    tr.setup()
    return tr, next(iter(tr.train_loader))


def phase_pose_seg_train(task: str, data: dict, card: str, seed: int = 0) -> dict:
    """The yolov8n-pose / -seg train step on its dataset (pose on the host and on the device
    route), `YOLO.train(epochs=1)`, `YOLO.val`, `YOLO(checkpoint)` and `YOLO.predict` of the 12
    JPEG frames (see the module docstring, phase 17)."""
    import torch

    from sar_yolo_tpu_torch import YOLO
    routes = {"pose": (("host", {}, False), ("device", {"copy_paste": 0.0}, True)),
              "segment": (("host", {"copy_paste": 0.5}, False),)}[task]
    steps = {}
    for route, rkw, on_device in routes:
        for label, kw in (("f32", {"amp": False}), ("amp", {})):
            tr, batch = _pose_seg_trainer(task, data, seed, **rkw, **kw)
            check(tr.device_augment == on_device and tr.meta["task"] == task,
                  f"{task} {route}: device_augment {tr.device_augment}")
            check((tr.model.compute_dtype == torch.bfloat16) == (label == "amp"),
                  f"{task} {route} {label}: compute dtype {tr.model.compute_dtype}")
            if task == "pose":
                check(tr.meta["kpt_shape"] == (17, 3) and batch["keypoints"].shape[2:] == (17, 3),
                      f"pose: kpt_shape {tr.meta['kpt_shape']}")
            else:
                check(batch["masks"].shape[1:] == (TRAIN_IMGSZ // 4,) * 2 and batch["masks"].max() > 1,
                      f"segment: masks {batch['masks'].shape}")
            total, items = tr.train_step(batch)
            items = items.cpu().numpy()
            check(np.isfinite(items).all() and (items[:2] > 0).all(),
                  f"{task} {route} {label} step: items {items}")
            steps[f"{route}_{label}"] = {"items": items.tolist(), **_timed_steps(tr, batch)}
            del tr, batch
            torch.cuda.empty_cache()
    print(json.dumps({"pose_seg_train_step": task, "loss_names": {"pose": "box pose kobj cls dfl",
                      "segment": "box seg cls dfl"}[task], **steps, "card": card}))
    name = {"pose": "yolov8n-pose.yaml", "segment": "yolov8n-seg.yaml"}[task]
    yolo = YOLO(name)
    t0 = time.perf_counter()
    metrics = yolo.train(data=data, imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, epochs=1, seed=seed,
                         workers=8, project="runs", name=f"chip_smoke_{task}_train", exist_ok=True,
                         **({"copy_paste": 0.5} if task == "segment" else {}))
    train_s = time.perf_counter() - t0
    key = {"pose": "(P)", "segment": "(M)"}[task]
    check(all(np.isfinite(list(metrics.values()))) and f"metrics/mAP50-95{key}" in metrics,
          f"YOLO.train {name}: metrics {metrics}")
    t0 = time.perf_counter()
    val = yolo.val(data=data, imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, workers=8, project="runs",
                   name=f"chip_smoke_{task}_val", exist_ok=True)
    val_s = time.perf_counter() - t0
    check(f"metrics/mAP50{key}" in val and all(np.isfinite(list(val.values()))),
          f"YOLO.val {name}: {val}")
    ckpt = YOLO(yolo.ckpt_dir)
    check(ckpt.task == task and ckpt.meta.get("kpt_shape") == yolo.meta.get("kpt_shape")
          and ckpt.meta.get("nm") == yolo.meta.get("nm") and ckpt.names == yolo.names,
          f"YOLO(checkpoint): task {ckpt.task}, meta {ckpt.meta.get('kpt_shape')}")
    # the trained object keeps the amp run's bf16 compute; the checkpoint serves float32
    frames = np.random.default_rng(seed).integers(0, 256, (2, *BENCH_HW, 3), np.uint8)
    a, b = (m.predict_batched(frames, imgsz=TRAIN_IMGSZ, conf=1e-3) for m in (yolo, ckpt))
    rows = (b[0] if task == "segment" else b)
    check(rows.shape[:2] == (2, 300) and np.isfinite(rows).all(),
          f"YOLO(checkpoint) {name}: served rows {rows.shape}")
    ckpt_val = ckpt.val(data=data, imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, workers=8,
                        project="runs", name=f"chip_smoke_{task}_ckpt_val", exist_ok=True)
    check(f"metrics/mAP50{key}" in ckpt_val and all(np.isfinite(list(ckpt_val.values()))),
          f"YOLO(checkpoint).val {name}: {ckpt_val}")
    t0 = time.perf_counter()
    results = ckpt.predict(str(JPEG_DIR / "frames"), imgsz=TRAIN_IMGSZ, conf=1e-3)
    predict_s = time.perf_counter() - t0
    check(len(results) == JPEG_FRAMES and all(
        (r.keypoints is not None) if task == "pose" else (r.masks is not None) for r in results),
        f"YOLO.predict {name}: {len(results)} results")
    print(json.dumps({"pose_seg_yolo_train": name, "metrics": metrics, "seconds": train_s,
                      "val": val, "val_s": val_s, "val_ms_per_image": val.get("speed/ms_per_image"),
                      "checkpoint_task": ckpt.task, "checkpoint_val": ckpt_val,
                      "checkpoint_rows_kept": ((b[0] if task == "segment" else b)[..., 4] > 0)
                      .sum(1).tolist(), "predict_jpeg_frames_per_s": JPEG_FRAMES / predict_s,
                      "predict_kept_per_frame": [len(r) for r in results], "card": card}))
    return {"steps": steps, "val": val}


def phase_pose_seg(card: str, seed: int = 5) -> tuple:
    """Phase 17: the pose and segment tasks served, fused, trained and validated on their own
    datasets; no graph of theirs has an A2C2f block. Returns the launches by path and the two
    datasets (phase 27 validates on them, then deletes them)."""
    import torch

    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention, reset_launches
    t0 = time.perf_counter()
    reset_launches()
    roots = {t: Path("runs") / f"chip_smoke_{t}_data" for t in ("pose", "segment")}
    data = {}
    for task, root in roots.items():
        shutil.rmtree(root, ignore_errors=True)
        data[task] = _write_pose_seg_dataset(root, task, seed + len(data))
    t_data = time.perf_counter()
    for name, batches in POSE_SEG_SERVE:
        phase_pose_seg_serve(name, batches, card)
    t_serve = time.perf_counter()
    for task in ("pose", "segment"):
        phase_pose_seg_train(task, data[task], card)
        torch.cuda.empty_cache()
    by = dict(flash_area_attention.launches_by_dtype)
    check(by == {"float32": 0, "bfloat16": 0}, f"phase 17: attention kernel launches {by}")
    print(json.dumps({"phase_pose_seg_s": {"datasets": t_data - t0, "serve": t_serve - t_data,
                                           "train_val": time.perf_counter() - t_serve},
                      "kernel_launches_by_dtype": by}))
    return {**{f"serve {n.removesuffix('.yaml')}@{DETECT_IMGSZ}, f32 and bf16": 0
               for n, _ in POSE_SEG_SERVE},
            f"yolov8n-pose train step @{TRAIN_IMGSZ} b{TRAIN_BATCH}, host and device route, f32 "
            "and amp": 0,
            f"yolov8n-seg train step @{TRAIN_IMGSZ} b{TRAIN_BATCH}, f32 and amp": 0,
            "YOLO.train / val / predict yolov8n-pose and yolov8n-seg": 0}, data


# phase 18: the OBB and classify tasks (no A2C2f block in any of their graphs)
OBB_IMGSZ = 1024          # DOTA's tile size
OBB_BATCHES = (1, 8)      # served tiles a call
OBB_TRAIN_BATCH = 8
OBB_BOX_TOL = 1e-3        # px: served boxes against float64, over the undecided candidates
OBB_ANGLE_TOL = 1e-5      # rad
OBB_MIN_CANDIDATES = 100  # rotated NMS's candidates a tile at the comparison's threshold
CLS_IMGSZ = 224           # ImageNet's size
CLS_BATCHES = (1, 8, 128)
CLS_TRAIN_BATCH = 64
CLS_FOLDER = (4, 32, 8)   # classes, train and val frames a class
PROB_TOL = 1e-5           # served probabilities against float64


def _aerial_tiles(n: int, seed: int, size: int) -> np.ndarray:
    """n uint8 BGR tiles of side `size`: terrain of 64 px colour cells with noise, and 24
    rotated rectangles of 12-90 px a tile (vehicles, roofs), drawn by `cv.fill_poly`."""
    from sar_yolo_tpu_torch.data.cv import fill_poly
    rng = np.random.default_rng(seed)
    cells = rng.integers(40, 200, (n, size // 64 + 1, size // 64 + 1, 3), np.uint8)
    tiles = np.repeat(np.repeat(cells, 64, 1), 64, 2)[:, :size, :size]
    tiles = (tiles + rng.integers(0, 24, tiles.shape, np.uint8)).astype(np.uint8)
    for t in tiles:
        for _ in range(24):
            w, h = rng.uniform(12, 90, 2)
            r = rng.uniform(0, np.pi)
            c = rng.uniform(60, size - 60, 2)
            rot = np.array([[np.cos(r), np.sin(r)], [-np.sin(r), np.cos(r)]])
            pts = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2 @ rot + c
            fill_poly(t, pts.astype(np.int32), tuple(int(v) for v in rng.integers(0, 256, 3)))
    return tiles


def _tie_free_obb(p32, p64, nc: int, conf: float, iou_thres: float = 0.7):
    """Decoded OBB rows (1, N, 4 + nc + 1) of one frame on the float32 path and on the model
    in float64, with the candidates whose fate no float32 rounding can decide zeroed in
    both: an anchor whose best float64 score lies within the margin of conf or of its second
    class's, or that overlaps another candidate of its class by a probiou within the pair's
    IoU margin of iou_thres or, beyond it, scores within the margin of it. The score margin
    is 4 x the float32 path's largest score distance from float64 (1e-8 at least); a pair's
    IoU margin 8 x (the largest box distance plus float32's spacing at the largest
    class-offset centre, where NMS rounds the moved centres) over the pair's smallest side
    (1e-6 at least). Returns (p32, p64, stats)."""
    import torch

    from sar_yolo_tpu_torch.ops.boxes import probiou
    p32, p64 = p32.clone(), p64.clone()
    r32, r64 = p32[0].double().cpu().numpy(), p64[0].cpu().numpy()
    s64 = r64[:, 4:4 + nc]
    margin = max(4 * float(np.abs(r32[:, 4:4 + nc] - s64).max()), 1e-8)
    top2 = np.sort(s64, -1)[:, -2:]
    cand = np.flatnonzero(top2[:, -1] >= conf - margin)
    b = r64[cand][:, [0, 1, 2, 3, -1]]
    c, sc = s64[cand].argmax(-1), top2[cand, -1]
    off = np.abs(b[:, :2]).max() + b[:, 2:4].max() + 1.0
    spacing = float(np.spacing(np.float32(c.max() * off + np.abs(b[:, :2]).max())))
    box_err = float(np.abs(r32[cand, :4] - r64[cand, :4]).max(initial=0))
    side = b[:, 2:4].min(1)
    iou_margin = np.maximum(8 * (box_err + spacing) / np.maximum(
        np.minimum(side[:, None], side[None]), 1e-9), 1e-6)
    t = torch.from_numpy(b)
    iou = probiou(t[:, None], t[None]).squeeze(-1).numpy()
    same = (c[:, None] == c[None]) & ~np.eye(len(c), dtype=bool)
    overlap = (same & ((np.abs(iou - iou_thres) < iou_margin)
                       | ((iou > iou_thres) & (np.abs(sc[:, None] - sc[None]) < margin)))).any(1)
    at_conf = np.abs(sc - conf) < margin
    class_tie = top2[cand, -1] - top2[cand, 0] < margin
    out = overlap | at_conf | class_tie
    drop = torch.as_tensor(cand[out])
    for p in (p32, p64):
        p[0, drop.to(p.device), 4:4 + nc] = 0.0
    return p32, p64, {"candidates": int((sc >= conf).sum()), "left_out": int(out.sum()),
                      "left_out_overlap": int(overlap.sum()), "left_out_at_conf":
                      int(at_conf.sum()), "left_out_class_tie": int(class_tie.sum()),
                      "score_margin": margin, "box_err_px": box_err,
                      "smallest_side_px": float(side.min(initial=np.inf))}


def _paired_obb(g, w, label: str) -> dict:
    """Kept rotated rows [cx, cy, w, h, r, conf, cls] of one frame, `w`'s paired to `g`'s by
    class and centre one to one; returns the largest box, angle and score differences."""
    g, w = g[g[:, 5] > 0], w[w[:, 5] > 0]
    check(len(g) == len(w) > 0, f"{label}: kept {len(g)} rows vs {len(w)}")
    check(len(g) < 300, f"{label}: max_det decides the comparison")
    match = (np.abs(g[:, None, :2] - w[None, :, :2]).max(-1)
             + 1e9 * (g[:, None, 6] != w[None, :, 6])).argmin(1)
    check(np.bincount(match, minlength=len(w)).max() == 1, f"{label}: rows do not pair up")
    w = w[match]
    check(np.array_equal(g[:, 6], w[:, 6]), f"{label}: classes differ")
    return {"box_err_px": float(np.abs(g[:, :4] - w[:, :4]).max()),
            "angle_err_rad": float(np.abs(g[:, 4] - w[:, 4]).max()),
            "score_err": float(np.abs(g[:, 5] - w[:, 5]).max())}


def phase_obb_serve(card: str, seed: int = 3) -> dict:
    """yolov8n-obb served at 1024 on aerial tiles, against float64 over the tie-free
    candidates; half, fuse(), img/s, decode + rotated NMS ms; yolo11n-obb at batch 8 (see
    the module docstring, phase 18)."""
    import torch

    from sar_yolo_tpu_torch.ops import nms
    from sar_yolo_tpu_torch.ops.decode import decode_obb
    nb = max(OBB_BATCHES)
    tiles = _aerial_tiles(nb, seed, OBB_IMGSZ)
    yolo = _perturbed_yolo("yolov8n-obb.yaml", seed, OBB_IMGSZ)
    # damped on every tile: a tile the gain does not see can drive its class scores to 1.0,
    # where they tie
    gain = _damp_class_logits(yolo, tiles, OBB_IMGSZ)
    box_gain = _damp_head_logits(yolo, tiles, OBB_IMGSZ)
    angle_gain = _damp_head_logits(yolo, tiles, OBB_IMGSZ, "cv4_", MAX_LOGIT)
    meta, nc = yolo.meta, yolo.meta["nc"]
    check(yolo.task == "obb" and nc == 80, f"yolov8n-obb: task {yolo.task}, nc {nc}")
    exact = _float64_copy(yolo)
    predictor = yolo._get_predictor({"imgsz": OBB_IMGSZ})
    x, r, pad = predictor.preprocess(tiles)
    check(r == 1.0 and tuple(pad) == (0, 0), f"1024 tiles at 1024: r {r}, pad {pad}")
    with torch.no_grad():
        p32 = decode_obb(yolo._fused_for_serving()(x), meta["strides"], nc, meta["reg_max"])
        m32, m64 = yolo._fused_for_serving()(x), exact._fused(x.double())
        maps_err = max((a.double() - b).abs().max().item() for a, b in zip(m32, m64))
        p64 = decode_obb(m64, meta["strides"], nc, meta["reg_max"])
    check(bool(torch.isfinite(p32).all() and torch.isfinite(p64).all()), "yolov8n-obb: rows")
    best = p64[..., 4:4 + nc].amax(-1).sort(1, descending=True).values.cpu().numpy()
    # each tile at the threshold of its 1000th best score: under PRE_TOPK candidates
    confs = [float(b[min(1000, len(b) - 1)]) for b in best]
    errs = {"box_err_px": 0.0, "angle_err_rad": 0.0, "score_err": 0.0}
    tie_stats, kept = [], []
    for i, conf in enumerate(confs):
        d32, d64, st = _tie_free_obb(p32[i:i + 1], p64[i:i + 1], nc, conf)
        tie_stats.append(st)
        kw = dict(conf_thres=conf, iou_thres=0.7, max_det=300, nc=nc)
        with torch.no_grad():
            got = nms.non_max_suppression_rotated(d32, **kw).cpu().numpy()
            want = nms.non_max_suppression_rotated(d64, **kw).cpu().numpy()
        kept.append(int((got[0, :, 5] > 0).sum()))
        check(st["candidates"] >= OBB_MIN_CANDIDATES and kept[-1] > 0,
              f"yolov8n-obb tile {i} at {conf}: {kept[-1]} rows kept, {st}")
        e = _paired_obb(got[0], want[0], f"yolov8n-obb tile {i} float32 vs float64")
        errs = {k: max(errs[k], e[k]) for k in errs}
    # a box moves by up to 2 strides x the maps' own float32 distance (the DFL expectation
    # over 16 bins), an angle by pi/4 x it (the sigmoid's slope); each bound is that or its
    # floor, whichever is larger
    box_tol = max(OBB_BOX_TOL, 2 * max(meta["strides"]) * maps_err)
    angle_tol = max(OBB_ANGLE_TOL, np.pi / 4 * maps_err)
    check(errs["box_err_px"] <= box_tol and errs["angle_err_rad"] <= angle_tol
          and errs["score_err"] <= PROB_TOL, f"yolov8n-obb float32 vs float64: {errs} (maps "
          f"{maps_err} apart)")
    del exact
    # the served route: rows of the BN-folded model, then half and fuse()
    served = {}
    for b in OBB_BATCHES:
        for label, hkw in (("f32", {}), ("bf16", {"half": True})):
            rows = yolo.predict_batched(tiles[:b], imgsz=OBB_IMGSZ, **hkw)
            check(rows.shape == (b, 300, 7) and np.isfinite(rows).all()
                  and (rows[..., 5] > 0).sum() > 0, f"yolov8n-obb b{b} {label}: {rows.shape}")
            served[f"kept_b{b}_{label}"] = (rows[..., 5] > 0).sum(1).tolist()
    folded = copy.deepcopy(yolo).fuse()
    check(np.array_equal(folded.predict_batched(tiles[:2], imgsz=OBB_IMGSZ),
                         yolo.predict_batched(tiles[:2], imgsz=OBB_IMGSZ)),
          "yolov8n-obb: fuse() serves other rows than the BN-folded serving copy")
    del folded
    # decode + rotated NMS at batch 8 (CUDA events), its candidates and fixed-point iterations
    with torch.no_grad():
        maps = yolo._fused_for_serving()(x)
        serve_cand = (decode_obb(maps, meta["strides"], nc, meta["reg_max"])[..., 4:4 + nc]
                      .amax(-1) >= 0.25).sum(1).tolist()

        def tail():
            preds = decode_obb(maps, meta["strides"], nc, meta["reg_max"])
            return nms.non_max_suppression_rotated(preds, conf_thres=0.25, iou_thres=0.7,
                                                   max_det=300, nc=nc)
        tail_ms = event_ms(tail, iters=5)
        iterations = nms.last_iterations[0]
    kw, hkw = dict(imgsz=OBB_IMGSZ), dict(imgsz=OBB_IMGSZ, half=True)
    rates = {}
    for b in OBB_BATCHES:
        rr = _rates(lambda: _img_per_s(yolo, tiles[:b], kw, n=3),
                    lambda: _img_per_s(yolo, tiles[:b], hkw, n=3))
        rates.update({f"img_per_s_b{b}_{k}": v for k, v in rr.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    yolo.predict_batched(tiles, **kw)
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    out = {"serve_obb": "yolov8n-obb.yaml", "imgsz": OBB_IMGSZ, "nc": nc,
           "class_logit_gain": gain, "box_logit_gain": box_gain, "angle_logit_gain": angle_gain,
           "maps_f32_vs_f64": maps_err, "box_tol_px": box_tol, "angle_tol_rad": angle_tol,
           "compare_confs": confs,
           "kept_per_tile": kept, "tie_free_per_tile": tie_stats, **errs, **served,
           f"decode_rotated_nms_ms_b{nb}": tail_ms, "nms_candidates_per_tile_conf_0.25":
           serve_cand, "nms_fixed_point_iterations": iterations, **rates,
           f"max_memory_allocated_gib_b{nb}_f32": mem, "card": card}
    print(json.dumps(out))
    del yolo
    torch.cuda.empty_cache()
    # yolo11n-obb at batch 8
    y11 = _perturbed_yolo("yolo11n-obb.yaml", seed, OBB_IMGSZ)
    _damp_class_logits(y11, tiles, OBB_IMGSZ)
    b8 = {}
    for label, hkw in (("f32", {}), ("bf16", {"half": True})):
        rows = y11.predict_batched(tiles, imgsz=OBB_IMGSZ, **hkw)
        check(rows.shape == (nb, 300, 7) and np.isfinite(rows).all(), f"yolo11n-obb {label}")
        b8[f"kept_{label}"] = (rows[..., 5] > 0).sum(1).tolist()
    rr = _rates(lambda: _img_per_s(y11, tiles, kw, n=3), lambda: _img_per_s(y11, tiles, hkw, n=3))
    print(json.dumps({"serve_obb": "yolo11n-obb.yaml", "imgsz": OBB_IMGSZ, **b8,
                      **{f"img_per_s_b{nb}_{k}": v for k, v in rr.items()}, "card": card}))
    del y11
    torch.cuda.empty_cache()
    return out


def phase_obb_train(card: str, seed: int = 0) -> dict:
    """The yolov8n-obb train step at 1024 on the synthetic set (float32 and amp), then
    `YOLO.train(epochs=1)`, `YOLO.val`, `YOLO(checkpoint)` and `YOLO.predict` of the JPEG
    frames (see the module docstring, phase 18)."""
    import torch

    from sar_yolo_tpu_torch import YOLO
    from sar_yolo_tpu_torch.engine.trainer import TRAINERS
    steps = {}
    for label, kw in (("f32", {"amp": False}), ("amp", {})):
        tr = TRAINERS["obb"](dict(model="yolov8n-obb.yaml", data="synthetic", imgsz=OBB_IMGSZ,
                                  batch=OBB_TRAIN_BATCH, seed=seed, optimizer="SGD",
                                  nbs=OBB_TRAIN_BATCH, warmup_epochs=0.0, workers=8,
                                  project="runs", name="chip_smoke_obb", exist_ok=True, **kw))
        tr.setup()
        check(not tr.device_augment and (tr.model.compute_dtype == torch.bfloat16) ==
              (label == "amp"), f"obb {label}: compute dtype {tr.model.compute_dtype}")
        batch = next(iter(tr.train_loader))
        check(batch["bboxes"].shape[2] == 5, f"obb: bboxes {batch['bboxes'].shape}")
        _, items = tr.train_step(batch)
        items = items.cpu().numpy()
        check(np.isfinite(items).all() and (items > 0).all(), f"obb {label} step: items {items}")
        steps[label] = {"items": items.tolist(), **_timed_steps(tr, batch)}
        del tr, batch
        torch.cuda.empty_cache()
    print(json.dumps({"obb_train_step":
                      f"yolov8n-obb@{OBB_IMGSZ} b{OBB_TRAIN_BATCH} synthetic nc 3",
                      "loss_names": "box cls dfl", **steps, "card": card}))
    yolo = YOLO("yolov8n-obb.yaml")
    t0 = time.perf_counter()
    metrics = yolo.train(data="synthetic", imgsz=OBB_IMGSZ, batch=OBB_TRAIN_BATCH, epochs=1,
                         seed=seed, workers=8, project="runs", name="chip_smoke_obb_train",
                         exist_ok=True)
    train_s = time.perf_counter() - t0
    check(all(np.isfinite(list(metrics.values()))) and "metrics/mAP50-95(B)" in metrics
          and "train/box" in metrics, f"YOLO.train yolov8n-obb: {metrics}")
    val = yolo.val(data="synthetic", imgsz=OBB_IMGSZ, batch=OBB_TRAIN_BATCH, workers=8,
                   project="runs", name="chip_smoke_obb_val", exist_ok=True)
    check("metrics/mAP50(B)" in val and all(np.isfinite(list(val.values()))), f"YOLO.val: {val}")
    ckpt = YOLO(yolo.ckpt_dir)
    check(ckpt.task == "obb" and ckpt.meta["nc"] == 3 and ckpt.names == yolo.names,
          f"YOLO(checkpoint): task {ckpt.task}, nc {ckpt.meta['nc']}")
    tiles = _aerial_tiles(2, seed, OBB_IMGSZ)
    rows = ckpt.predict_batched(tiles, imgsz=OBB_IMGSZ, conf=1e-3)
    check(rows.shape == (2, 300, 7) and np.isfinite(rows).all(), f"checkpoint rows {rows.shape}")
    ckpt_val = ckpt.val(data="synthetic", imgsz=OBB_IMGSZ, batch=OBB_TRAIN_BATCH, workers=8,
                        project="runs", name="chip_smoke_obb_ckpt_val", exist_ok=True)
    check("metrics/mAP50(B)" in ckpt_val, f"YOLO(checkpoint).val: {ckpt_val}")
    t0 = time.perf_counter()
    results = ckpt.predict(str(JPEG_DIR / "frames"), imgsz=OBB_IMGSZ, conf=1e-3)
    predict_s = time.perf_counter() - t0
    check(len(results) == JPEG_FRAMES and all(r.obb is not None and r.boxes is None
                                              for r in results), "YOLO.predict yolov8n-obb")
    out = {"obb_yolo_train": "yolov8n-obb.yaml", "metrics": metrics, "seconds": train_s,
           "val": val, "checkpoint_val": ckpt_val,
           "checkpoint_rows_kept": (rows[..., 5] > 0).sum(1).tolist(),
           "predict_jpeg_frames_per_s": JPEG_FRAMES / predict_s,
           "predict_kept_per_frame": [len(r) for r in results], "card": card}
    print(json.dumps(out))
    return {"steps": steps, "val": val}


def _write_cls_folder(root: Path, seed: int) -> Path:
    """A class-folder dataset of PNG frames under `root`: train/ and val/, CLS_FOLDER's
    classes and frames a class, 240x320 (one in four 320x240), terrain as phase 8's with a
    disc, a bar, a ring or a cross of a class colour somewhere in it."""
    rng = np.random.default_rng(seed)
    n_cls, n_train, n_val = CLS_FOLDER
    colours = rng.integers(0, 256, (n_cls, 3), np.uint8)
    for split, n in (("train", n_train), ("val", n_val)):
        for c in range(n_cls):
            d = root / split / f"class{c}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = (320, 240) if i % 4 == 0 else (240, 320)
                cells = rng.integers(40, 200, (h // 40 + 1, w // 40 + 1, 3), np.uint8)
                img = np.repeat(np.repeat(cells, 40, 0), 40, 1)[:h, :w]
                img = (img + rng.integers(0, 24, (h, w, 3), np.uint8)).astype(np.uint8)
                cy, cx = rng.integers(50, h - 50), rng.integers(50, w - 50)
                yy, xx = np.mgrid[:h, :w]
                rad = np.hypot(yy - cy, xx - cx)
                shape = [rad < 40, (np.abs(yy - cy) < 10) & (np.abs(xx - cx) < 45),
                         (rad < 40) & (rad > 25),
                         ((np.abs(yy - cy) < 8) | (np.abs(xx - cx) < 8)) & (rad < 45)][c % 4]
                img[shape] = colours[c]
                (d / f"{i:03d}.png").write_bytes(_png_file(img))
    return root


def _top5_agree(l32: np.ndarray, l64: np.ndarray) -> tuple:
    """Rows of logits: the top-5 of each row of l32 against l64's, up to the first rank at
    which two float64 logits lie within 4 x the largest float32 distance (1e-6 at least) of
    each other. Returns (ranks compared, rows whose order differs there)."""
    margin = max(4 * float(np.abs(l32 - l64).max()), 1e-6)
    compared, differ = 0, 0
    for a, b in zip(l32, l64):
        order = np.argsort(-b, kind="stable")[:6]
        gaps = -np.diff(b[order])
        k = int(np.argmax(gaps < margin)) if (gaps < margin).any() else 5
        k = min(k, 5)
        compared += k
        differ += int(not np.array_equal(np.argsort(-a, kind="stable")[:k], order[:k]))
    return compared, differ


def phase_cls_serve(card: str, seed: int = 3) -> dict:
    """yolov8n-cls served at 224 on phase 14's ragged 480x640 frames: probabilities and
    top-5 against float64, half, fuse(), img/s; yolo11n-cls and yolo11n-cls-resnet18 at
    batch 8 (see the module docstring, phase 18)."""
    import torch
    frames = np.random.default_rng(seed).integers(0, 256, (max(CLS_BATCHES), *BENCH_HW, 3),
                                                  np.uint8)
    outs = {}
    for name in ("yolov8n-cls.yaml", "yolo11n-cls.yaml", "yolo11n-cls-resnet18.yaml"):
        yolo = _perturbed_yolo(name, seed, CLS_IMGSZ)
        nc = yolo.meta["nc"]
        check(yolo.task == "classify" and yolo.meta["strides"] == [], f"{name}: {yolo.task}")
        batches = CLS_BATCHES if name == "yolov8n-cls.yaml" else (8,)
        exact = _float64_copy(yolo)
        b8 = frames[:8]
        got = yolo.predict_batched(b8, imgsz=CLS_IMGSZ)
        want = exact.predict_batched(b8, imgsz=CLS_IMGSZ)
        x, _, _ = yolo._get_predictor({"imgsz": CLS_IMGSZ}).preprocess(b8)
        with torch.no_grad():
            l32 = yolo._fused_for_serving()(x).double().cpu().numpy()
            l64 = exact._fused(x.double()).cpu().numpy()
        compared, differ = _top5_agree(l32, l64)
        prob_err = float(np.abs(got - want).max())
        check(got.shape == (8, nc) and prob_err <= PROB_TOL and differ == 0 and compared > 0,
              f"{name} float32 vs float64: probs {prob_err}, top-5 {differ} rows differ")
        del exact
        half = yolo.predict_batched(b8, imgsz=CLS_IMGSZ, half=True)
        check(half.shape == (8, nc) and np.isfinite(half).all() and
              np.allclose(half.sum(1), 1, atol=1e-2), f"{name} half: {half.shape}")
        folded = copy.deepcopy(yolo).fuse()
        check(np.array_equal(folded.predict_batched(b8, imgsz=CLS_IMGSZ), got),
              f"{name}: fuse() serves other probabilities than the BN-folded serving copy")
        del folded
        kw, hkw = dict(imgsz=CLS_IMGSZ), dict(imgsz=CLS_IMGSZ, half=True)
        rates = {}
        for b in batches:
            rr = _rates(lambda: _img_per_s(yolo, frames[:b], kw, n=3),
                        lambda: _img_per_s(yolo, frames[:b], hkw, n=3))
            rates.update({f"img_per_s_b{b}_{k}": v for k, v in rr.items()})
        outs[name] = {"serve_cls": name, "imgsz": CLS_IMGSZ, "nc": nc,
                      "frames": f"{BENCH_HW[0]}x{BENCH_HW[1]}", "prob_err_vs_f64": prob_err,
                      "logit_err_vs_f64": float(np.abs(l32 - l64).max()),
                      "top5_ranks_compared": compared, "top1_prob_median":
                      float(np.median(got.max(1))), **rates, "card": card}
        print(json.dumps(outs[name]))
        del yolo
        torch.cuda.empty_cache()
    return outs


def phase_cls_train(root: Path, card: str, seed: int = 0) -> dict:
    """The yolov8n-cls train step at 224, batch 64, on the class folder (float32 and amp),
    then `YOLO.train(epochs=1)`, `YOLO.val` and `YOLO(checkpoint)` (see the module
    docstring, phase 18)."""
    import torch

    from sar_yolo_tpu_torch import YOLO
    from sar_yolo_tpu_torch.engine.trainer import TRAINERS
    n_cls = CLS_FOLDER[0]
    steps = {}
    for label, kw in (("f32", {"amp": False}), ("amp", {})):
        tr = TRAINERS["classify"](dict(model="yolov8n-cls.yaml", data=str(root), imgsz=CLS_IMGSZ,
                                       batch=CLS_TRAIN_BATCH, seed=seed, optimizer="SGD",
                                       nbs=CLS_TRAIN_BATCH, warmup_epochs=0.0, workers=8,
                                       project="runs", name="chip_smoke_cls", exist_ok=True, **kw))
        tr.setup()
        check(tr.meta["nc"] == n_cls and (tr.model.compute_dtype == torch.bfloat16) ==
              (label == "amp"), f"classify {label}: nc {tr.meta['nc']}")
        batch = next(iter(tr.train_loader))
        check(batch["img"].shape == (CLS_TRAIN_BATCH, CLS_IMGSZ, CLS_IMGSZ, 3),
              f"classify batch {batch['img'].shape}")
        _, items = tr.train_step(batch)
        items = items.cpu().numpy()
        check(np.isfinite(items).all() and (items > 0).all(), f"classify {label}: items {items}")
        steps[label] = {"items": items.tolist(), **_timed_steps(tr, batch)}
        del tr, batch
        torch.cuda.empty_cache()
    print(json.dumps({"cls_train_step": f"yolov8n-cls@{CLS_IMGSZ} b{CLS_TRAIN_BATCH} "
                      f"class folder nc {n_cls}", "loss_names": "loss", **steps, "card": card}))
    yolo = YOLO("yolov8n-cls.yaml")
    t0 = time.perf_counter()
    metrics = yolo.train(data=str(root), imgsz=CLS_IMGSZ, batch=CLS_TRAIN_BATCH, epochs=1,
                         seed=seed, workers=8, project="runs", name="chip_smoke_cls_train",
                         exist_ok=True)
    train_s = time.perf_counter() - t0
    check({"train/loss", "metrics/accuracy_top1", "metrics/accuracy_top5"} <= set(metrics)
          and all(np.isfinite(list(metrics.values()))), f"YOLO.train yolov8n-cls: {metrics}")
    val = yolo.val(data=str(root), imgsz=CLS_IMGSZ, batch=CLS_TRAIN_BATCH, workers=8,
                   project="runs", name="chip_smoke_cls_val", exist_ok=True)
    check(val["metrics/accuracy_top5"] >= val["metrics/accuracy_top1"] and
          val["metrics/accuracy_top5"] == 1.0, f"YOLO.val yolov8n-cls ({n_cls} classes): {val}")
    ckpt = YOLO(yolo.ckpt_dir)
    check(ckpt.task == "classify" and ckpt.names == {c: f"class{c}" for c in range(n_cls)},
          f"YOLO(checkpoint): {ckpt.task} {ckpt.names}")
    ckpt_val = ckpt.val(data=str(root), imgsz=CLS_IMGSZ, batch=CLS_TRAIN_BATCH, workers=8,
                        project="runs", name="chip_smoke_cls_ckpt_val", exist_ok=True)
    check(ckpt_val.keys() == val.keys(), f"YOLO(checkpoint).val: {ckpt_val}")
    out = {"cls_yolo_train": "yolov8n-cls.yaml", "metrics": metrics, "seconds": train_s,
           "val": val, "checkpoint_val": ckpt_val, "card": card}
    print(json.dumps(out))
    return out


def phase_obb_cls(card: str, seed: int = 6) -> dict:
    """Phase 18: the OBB and classify tasks served, fused, trained and validated; no graph of
    theirs has an A2C2f block. Returns the launches by path."""
    import torch

    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention, reset_launches
    t0 = time.perf_counter()
    reset_launches()
    phase_obb_serve(card)
    t_obb_serve = time.perf_counter()
    phase_obb_train(card)
    torch.cuda.empty_cache()
    t_obb_train = time.perf_counter()
    phase_cls_serve(card)
    t_cls_serve = time.perf_counter()
    root = Path("runs") / "chip_smoke_cls_data"
    shutil.rmtree(root, ignore_errors=True)
    phase_cls_train(_write_cls_folder(root, seed), card)
    shutil.rmtree(root, ignore_errors=True)
    by = dict(flash_area_attention.launches_by_dtype)
    check(by == {"float32": 0, "bfloat16": 0}, f"phase 18: attention kernel launches {by}")
    print(json.dumps({"phase_obb_cls_s": {"obb_serve": t_obb_serve - t0,
                                          "obb_train_val": t_obb_train - t_obb_serve,
                                          "cls_serve": t_cls_serve - t_obb_train,
                                          "cls_train_val": time.perf_counter() - t_cls_serve},
                      "kernel_launches_by_dtype": by}))
    return {f"serve yolov8n-obb and yolo11n-obb@{OBB_IMGSZ}, f32 and bf16": 0,
            f"yolov8n-obb train step @{OBB_IMGSZ} b{OBB_TRAIN_BATCH}, f32 and amp": 0,
            "YOLO.train / val / predict yolov8n-obb": 0,
            f"serve yolov8n-cls, yolo11n-cls, yolo11n-cls-resnet18@{CLS_IMGSZ}, f32 and bf16": 0,
            f"yolov8n-cls train step @{CLS_IMGSZ} b{CLS_TRAIN_BATCH}, f32 and amp": 0,
            "YOLO.train / val yolov8n-cls": 0}


RTDETR_IMGSZ = 640        # Ultralytics' RT-DETR serving size
# (name, served batches, least frames of RTDETR_AB_BATCH on which float32 and float64 pick
# the same top-300 end to end): the backbone's float32 rounding moves the encoder scores by
# ~1e-3 (rtdetr-l) to ~2e-2 (rtdetr-resnet50) against top-k gaps of 1e-4 to 3e-2
RTDETR_SERVE = (("rtdetr-l.yaml", (1, 8, 128), 2), ("rtdetr-resnet50.yaml", (8,), 0),
                ("yolov8n-rtdetr.yaml", (8,), 1))
RTDETR_AB_BATCH = 8       # frames of the float32 / float64 row comparison
RTDETR_TRAIN_BATCH = 16
RTDETR_BOX_TOL = 2e-4     # of imgsz (0.128 px at 640): the float32 decoder's boxes vs float64
RTDETR_SCORE_TOL = 1e-3   # served scores against float64
RTDETR_BF16_OVERLAP = 0.9  # bf16 decoder on float32's inputs: least top-k overlap a frame
RTDETR_BF16_BOX_REL = 0.1  # and largest box relative L2 a frame
RTDETR_BOX_GAIN = 0.1     # on the decoder layers' box deltas (see phase_rtdetr_serve)
WORLD_SERVE = (("yolov8s-world.yaml", (1, 8)), ("yolov8s-worldv2.yaml", (8,)))
WORLD_NAMES = ["person", "boat", "car", "backpack"]
GROUNDING_FRAMES = (8, (480, 640))  # the grounding dataset's PNG frames and their size


def _overlap_rel(a: dict, b: dict) -> tuple:
    """Per frame: the share of b's top-nq tokens that a selects too, and the relative L2
    distance of a's boxes from b's over those tokens."""
    nq = a["box"].shape[1]
    overlap, rel = [], []
    for f in range(len(a["box"])):
        ia = np.argsort(-np.nan_to_num(a["best"][f], nan=-np.inf), kind="stable")[:nq]
        ib = np.argsort(-b["best"][f], kind="stable")[:nq]
        both = np.intersect1d(ia, ib)
        overlap.append(len(both) / nq)
        ga = a["box"][f][[int(np.flatnonzero(ia == t)[0]) for t in both]]
        gb = b["box"][f][[int(np.flatnonzero(ib == t)[0]) for t in both]]
        rel.append(float(np.linalg.norm(ga - gb) / np.linalg.norm(gb)))
    return overlap, rel


def _rtdetr_half_vs_f32(yolo, frames) -> dict:
    """`half` serving against float32: the served rows finite; the bf16 decoder on the
    float32 model's decoder inputs (rounded to bf16) against the float32 decoder on them
    (its own rounding: top-k overlap and box relative L2), and end to end."""
    import torch
    rows = yolo.predict_batched(frames, imgsz=RTDETR_IMGSZ, conf=0.0, half=True)
    p = yolo._get_predictor({"imgsz": RTDETR_IMGSZ, "conf": 0.0})
    x, _, _ = p.preprocess(frames)
    m32, mh = yolo._fused_for_serving(), yolo._fused_for_serving(True)
    inputs = {}
    for key, m, xx in (("f32", m32, x), ("bf16", mh, x.to(torch.bfloat16))):
        hook = m.blocks[-1].register_forward_pre_hook(
            lambda mod, a, key=key: inputs.__setitem__(key, [t.clone() for t in a[0]]))
        with torch.no_grad():
            m(xx)
        hook.remove()
    ref = _decoder_run(m32.blocks[-1], inputs["f32"], RTDETR_IMGSZ)
    own = _decoder_run(mh.blocks[-1], [t.to(torch.bfloat16) for t in inputs["f32"]],
                       RTDETR_IMGSZ)
    e2e = _decoder_run(mh.blocks[-1], inputs["bf16"], RTDETR_IMGSZ)
    own_ov, own_rel = _overlap_rel(own, ref)
    e2e_ov, e2e_rel = _overlap_rel(e2e, ref)
    return {"rows_finite": bool(np.isfinite(rows).all()) and rows.shape[2] == 6,
            "decoder_own_topk_overlap": own_ov, "decoder_own_box_rel_l2": own_rel,
            "end_to_end_topk_overlap": e2e_ov, "end_to_end_box_rel_l2": e2e_rel}


def _decoder_run(dec, xs, imgsz: int) -> dict:
    """The RT-DETR decoder `dec` (eval) on its input maps xs: the last layer's boxes in
    letterboxed px (B, nq, 4) and class probabilities (B, nq, nc), and the best valid encoder
    score of every token (B, tokens), all float64 numpy."""
    import torch
    seen = {}
    hook = dec.enc_score_head.register_forward_hook(lambda m, a, o: seen.__setitem__("enc", o))
    try:
        with torch.no_grad():
            dec_b, dec_s = dec(xs)[:2]
    finally:
        hook.remove()
    _, valid = dec._anchors([tuple(x.shape[2:]) for x in xs], xs[0].device)
    best = torch.where(valid[..., 0], seen["enc"].amax(-1).double(), -torch.inf)
    return {"box": (dec_b[-1].double() * imgsz).cpu().numpy(),
            "prob": torch.sigmoid(dec_s[-1].double()).cpu().numpy(), "best": best.cpu().numpy()}


def _decoder_vs(a: dict, b: dict) -> dict:
    """Per frame, run a against run b: tie-free (the same top-nq tokens, and b's nq-th and
    (nq + 1)-th best encoder scores farther apart than twice the two runs' largest encoder
    score difference), and over each token's query the largest box (px) and best-class
    score differences and the class mismatches where b's top two classes are farther apart
    than twice the runs' largest probability difference."""
    nq = a["box"].shape[1]
    out = []
    for f in range(len(a["box"])):
        fin = np.isfinite(b["best"][f])
        err = float(np.abs(a["best"][f][fin] - b["best"][f][fin]).max())
        s = np.sort(b["best"][f][fin])[::-1]
        ia = np.argsort(-a["best"][f], kind="stable")[:nq]
        ib = np.argsort(-b["best"][f], kind="stable")[:nq]
        tie_free = bool(s[nq - 1] - s[nq] > 2 * err) and set(ia) == set(ib)
        pa, pb = a["prob"][f][np.argsort(ia)], b["prob"][f][np.argsort(ib)]
        box = np.abs(a["box"][f][np.argsort(ia)] - b["box"][f][np.argsort(ib)]).max()
        top2 = np.sort(pb, -1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 2 * np.abs(pa - pb).max()
        mismatch = int((pa[decided].argmax(-1) != pb[decided].argmax(-1)).sum())
        score = float(np.abs(pa.max(-1) - pb.max(-1)).max())
        out.append({"tie_free": tie_free, "gap": float(s[nq - 1] - s[nq]), "enc_err": err,
                    "box_err_px": float(box) if tie_free else None,
                    "score_err": score if tie_free else None,
                    "class_mismatches": mismatch if tie_free else None})
    return out


def _rtdetr_rows_vs_f64(yolo, exact, frames, label: str) -> dict:
    """The float32 serving path against the float64 copy on the same letterboxed frames,
    over the frames tie-free in all three runs below, each query paired by its token (the
    decoder is equivariant to the queries' order): end to end (float32 model against
    float64 model); the decoder's own rounding (the float32 decoder on the float64 model's
    decoder inputs); and the decoder's sensitivity to its inputs' rounding (the float64
    decoder on the float32 model's decoder inputs). Returns their largest errors."""
    import torch
    p = yolo._get_predictor({"imgsz": RTDETR_IMGSZ, "conf": 0.0})
    x, _, _ = p.preprocess(frames)
    m32, m64 = yolo._fused_for_serving(), exact._fused
    inputs = {}
    for key, m, xx in (("f32", m32, x), ("f64", m64, x.double())):
        hook = m.blocks[-1].register_forward_pre_hook(
            lambda mod, a, key=key: inputs.__setitem__(key, [t.clone() for t in a[0]]))
        with torch.no_grad():
            m(xx)
        hook.remove()
    d32, d64 = m32.blocks[-1], m64.blocks[-1]
    ref = _decoder_run(d64, inputs["f64"], RTDETR_IMGSZ)
    runs = {"end_to_end": _decoder_vs(_decoder_run(d32, inputs["f32"], RTDETR_IMGSZ), ref),
            "decoder_own": _decoder_vs(_decoder_run(
                d32, [t.float() for t in inputs["f64"]], RTDETR_IMGSZ), ref),
            "input_rounding": _decoder_vs(_decoder_run(
                d64, [t.double() for t in inputs["f32"]], RTDETR_IMGSZ), ref)}
    # the decoder's own rounding over the frames where it picks float64's top-k; end to end
    # and the inputs' rounding over the frames where both do
    own = [f for f in range(len(frames)) if runs["decoder_own"][f]["tie_free"]]
    e2e = [f for f in own if runs["end_to_end"][f]["tie_free"] and
           runs["input_rounding"][f]["tie_free"]]
    out = {"decoder_own_frames": own, "end_to_end_frames": e2e,
           "topk_gaps": [r["gap"] for r in runs["end_to_end"]],
           "enc_score_err": [r["enc_err"] for r in runs["end_to_end"]],
           "decoder_input_err": max((a.double() - b).abs().max().item()
                                    for a, b in zip(inputs["f32"], inputs["f64"]))}
    for key, per in runs.items():
        for k in ("box_err_px", "score_err", "class_mismatches"):
            out[f"{key}_{k}"] = max((per[f][k] for f in (own if key == "decoder_own" else e2e)),
                                    default=None)
    return out


def phase_rtdetr_serve(name: str, batches, min_e2e: int, card: str, seed: int = 3) -> dict:
    """An RT-DETR model served at 640 on phase 14's ragged 480x640 frames (see the module
    docstring, phase 19)."""
    import torch
    yolo = _perturbed_yolo(name, seed, RTDETR_IMGSZ)
    check(type(yolo._get_predictor({"imgsz": RTDETR_IMGSZ})).__name__ == "RTDETRPredictor",
          f"{name}: not served by RTDETRPredictor")
    # With perturbed random weights each decoder layer amplifies rounding ~7x (the features
    # are white noise in space, so a box that moves moves every sampled value): 12 px after
    # 6 layers at 640, in float32 against float64 on the same inputs. Damped box deltas
    # refine the boxes contractively, as a trained decoder does.
    dec = yolo.model.blocks[-1]
    with torch.no_grad():
        for i in range(dec.ndl):
            last = getattr(dec, f"dec_bbox_head_{i}").l2
            last.weight.mul_(RTDETR_BOX_GAIN)
            last.bias.mul_(RTDETR_BOX_GAIN)
    yolo._drop_caches()
    frames = np.random.default_rng(seed).integers(
        0, 256, (max(max(batches), RTDETR_AB_BATCH), *BENCH_HW, 3), np.uint8)
    ab = frames[:RTDETR_AB_BATCH]
    exact = _float64_copy(yolo)
    cmp = _rtdetr_rows_vs_f64(yolo, exact, ab, name)
    check(len(cmp["decoder_own_frames"]) >= len(ab) // 2 and
          len(cmp["end_to_end_frames"]) >= min_e2e, f"{name}: too few of {len(ab)} frames "
          f"tie-free at the top-k: {cmp}")
    # the decoder's own float32 rounding: tight; end to end: as far as the decoder's own
    # rounding and its inputs' rounding move the rows
    check(cmp["decoder_own_box_err_px"] <= RTDETR_BOX_TOL * RTDETR_IMGSZ and
          cmp["decoder_own_score_err"] <= RTDETR_SCORE_TOL and
          cmp["decoder_own_class_mismatches"] == 0, f"{name} float32 vs float64: {cmp}")
    if cmp["end_to_end_frames"]:
        check(cmp["end_to_end_class_mismatches"] == 0, f"{name} end to end: {cmp}")
        for k, floor in (("box_err_px", 1e-3), ("score_err", 1e-5)):
            bound = 2 * (cmp[f"decoder_own_{k}"] + cmp[f"input_rounding_{k}"]) + floor
            check(cmp[f"end_to_end_{k}"] <= bound, f"{name} float32 vs float64 end to end: {k} "
                  f"{cmp[f'end_to_end_{k}']} > {bound}: {cmp}")
    del exact
    got = yolo.predict_batched(ab, imgsz=RTDETR_IMGSZ, conf=0.25)
    half = _rtdetr_half_vs_f32(yolo, ab)
    # bf16 keeps ~3 significant digits: its own rounding moves the decoder's boxes by a few
    # percent (relative L2); end to end (the backbone in bf16 too) is printed, not bounded
    check(half["rows_finite"] and min(half["decoder_own_topk_overlap"]) >= RTDETR_BF16_OVERLAP
          and max(half["decoder_own_box_rel_l2"]) <= RTDETR_BF16_BOX_REL,
          f"{name} half vs float32: {half}")
    kw, hkw = dict(imgsz=RTDETR_IMGSZ, conf=0.25), dict(imgsz=RTDETR_IMGSZ, conf=0.25, half=True)
    torch.cuda.empty_cache()
    rates = {}
    for b in batches:
        rr = _rates(lambda: _img_per_s(yolo, frames[:b], kw, n=3),
                    lambda: _img_per_s(yolo, frames[:b], hkw, n=3))
        rates.update({f"img_per_s_b{b}_{k}": v for k, v in rr.items()})
    big = max(batches)
    memory = {}
    for label, args in (("f32", kw), ("bf16", hkw)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        yolo.predict_batched(frames[:big], **args)
        memory[f"max_memory_allocated_gib_b{big}_{label}"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
    out = {"serve_rtdetr": name, "imgsz": RTDETR_IMGSZ, "nc": yolo.meta["nc"],
           "queries": got.shape[1], "frames": f"{BENCH_HW[0]}x{BENCH_HW[1]}",
           "box_delta_gain": RTDETR_BOX_GAIN, **cmp,
           "kept_per_frame_conf_0.25": (got[..., 4] > 0).sum(1).tolist(),
           **{f"half_{k}": v for k, v in half.items()}, **rates, **memory,
           "card": card}
    print(json.dumps(out))
    del yolo
    torch.cuda.empty_cache()
    return out


def _rtdetr_step_parts(tr, batch, n: int = 5, warmup: int = 2) -> dict:
    """Median host-clock ms of an RT-DETR train step and of its parts, each synchronized:
    the batch to the card, the forward (with its denoising queries), the 7 x B matching
    costs on the card, the matching (one copy of the costs to the host, scipy, the indices
    back), the loss terms, the backward, the optimizer and EMA."""
    import torch

    from sar_yolo_tpu_torch.utils.detr_loss import detr_loss, matching_costs, solve_assignments

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    for _ in range(warmup):
        tr.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = [sync_ms(lambda: tr.train_step(batch))[1] for _ in range(n)]
    keys = ("to_device_ms", "forward_ms", "costs_ms", "matching_host_ms", "loss_ms",
            "backward_ms", "optimizer_ema_ms")
    parts = {k: [] for k in keys}
    for _ in range(n):
        b, t0 = sync_ms(lambda: tr.to_device(batch))
        out, t1 = sync_ms(lambda: tr.forward(b))

        def costs():
            with torch.no_grad():
                return matching_costs(torch.cat([out[0], out[2][None]]),
                                      torch.cat([out[1], out[3][None]]), b["bboxes"].float(),
                                      b["cls"], b["mask"].float())
        c, t2 = sync_ms(costs)
        assign, t3 = sync_ms(lambda: solve_assignments(c, b["mask"]))
        loss, t4 = sync_ms(lambda: detr_loss(out, b, assign))
        t5 = sync_ms(loss.total.backward)[1]
        t6 = sync_ms(lambda: tr.update(tr.cb_counts))[1]
        for k, t in zip(keys, (t0, t1, t2, t3, t4, t5, t6)):
            parts[k].append(t)
    return {"step_ms": statistics.median(step),
            "img_per_s": 1e3 * len(batch["img"]) / statistics.median(step),
            **{k: statistics.median(v) for k, v in parts.items()},
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_rtdetr_train(card: str, seed: int = 0) -> dict:
    """The rtdetr-l train step @640, batch 16, on synthetic data, float32 and amp, then
    `RTDETR.train(epochs=1)` with its validation and `YOLO(checkpoint)` served (see the
    module docstring, phase 19)."""
    import torch

    from sar_yolo_tpu_torch import RTDETR, YOLO
    from sar_yolo_tpu_torch.engine.trainer import RTDETRTrainer
    steps = {}
    for label, kw in (("f32", {"amp": False}), ("amp", {})):
        tr = RTDETRTrainer(dict(model="rtdetr-l.yaml", data="synthetic", imgsz=RTDETR_IMGSZ,
                                batch=RTDETR_TRAIN_BATCH, seed=seed, optimizer="SGD",
                                nbs=RTDETR_TRAIN_BATCH, warmup_epochs=0.0, workers=8,
                                project="runs", name="chip_smoke_rtdetr", exist_ok=True, **kw))
        tr.setup()
        check((tr.model.compute_dtype == torch.bfloat16) == (label == "amp"),
              f"rtdetr {label}: compute dtype {tr.model.compute_dtype}")
        batch = next(iter(tr.train_loader))
        _, items = tr.train_step(batch)
        items = items.cpu().numpy()
        check(np.isfinite(items).all() and (items > 0).all(), f"rtdetr {label}: items {items}")
        steps[label] = {"items": items.tolist(), "gt_per_image": float(batch["mask"].sum(1).mean()),
                        **_rtdetr_step_parts(tr, batch)}
        del tr, batch
        torch.cuda.empty_cache()
    print(json.dumps({"rtdetr_train_step": f"rtdetr-l@{RTDETR_IMGSZ} b{RTDETR_TRAIN_BATCH} "
                      "synthetic nc 3, 6 decoder layers + encoder matched, dn queries on",
                      "loss_names": "cls bbox giou", **steps, "card": card}))
    yolo = RTDETR("rtdetr-l.yaml")
    t0 = time.perf_counter()
    metrics = yolo.train(data="synthetic", imgsz=RTDETR_IMGSZ, batch=RTDETR_TRAIN_BATCH,
                         epochs=1, seed=seed, workers=8, project="runs",
                         name="chip_smoke_rtdetr_train", exist_ok=True)
    train_s = time.perf_counter() - t0
    check({"train/cls", "train/bbox", "train/giou", "metrics/mAP50(B)"} <= set(metrics) and
          all(np.isfinite(list(metrics.values()))), f"RTDETR.train rtdetr-l: {metrics}")
    ckpt = YOLO(yolo.ckpt_dir)
    frames = np.random.default_rng(seed).integers(0, 256, (2, *BENCH_HW, 3), np.uint8)
    rows = ckpt.predict_batched(frames, imgsz=RTDETR_IMGSZ, conf=0.0)
    check(type(ckpt._get_predictor({"imgsz": RTDETR_IMGSZ, "conf": 0.0})).__name__ ==
          "RTDETRPredictor" and rows.shape == (2, 300, 6) and np.isfinite(rows).all(),
          f"YOLO(checkpoint) rtdetr-l: rows {rows.shape}")
    out = {"rtdetr_yolo_train": "rtdetr-l.yaml", "metrics": metrics, "seconds": train_s,
           "checkpoint_rows": list(rows.shape), "card": card}
    print(json.dumps(out))
    del yolo, ckpt
    torch.cuda.empty_cache()
    return out


def _world_yolo(name: str, seed: int):
    """YOLOWorld `name` with seeded, perturbed weights and the WORLD_NAMES vocabulary."""
    from sar_yolo_tpu_torch import YOLOWorld
    yolo = _perturbed_yolo(name, seed, RTDETR_IMGSZ, cls=YOLOWorld)
    yolo.set_classes(WORLD_NAMES)
    return yolo


def phase_world_serve(name: str, batches, card: str, seed: int = 3) -> dict:
    """A YOLO-World model served at 640 with a 4-name vocabulary (see the module docstring,
    phase 19)."""
    import torch
    yolo = _world_yolo(name, seed)
    meta = yolo.meta
    check(meta["nc"] == len(WORLD_NAMES) and yolo.model.text_embeddings.shape[0] ==
          len(WORLD_NAMES), f"{name}: nc {meta['nc']} after set_classes")
    frames = np.random.default_rng(seed).integers(0, 256, (max(batches), *BENCH_HW, 3), np.uint8)
    ab = frames[:2]
    exact = _float64_copy(yolo)
    predictor = yolo._get_predictor({"imgsz": RTDETR_IMGSZ})
    confs, got, want = [], [], []
    for i in range(len(ab)):
        with torch.no_grad():
            rows, _ = predictor.decode(predictor.model(predictor.preprocess(ab[i:i + 1])[0]))
        conf = _nms_stable_conf(rows.double().cpu().numpy(), meta["nc"], 0.7,
                                DETECT_CANDIDATES)[0]
        confs.append(conf)
        got.append(yolo.predict_batched(ab[i:i + 1], imgsz=RTDETR_IMGSZ, conf=conf))
        want.append(exact.predict_batched(ab[i:i + 1], imgsz=RTDETR_IMGSZ, conf=conf))
    got, want = np.concatenate(got), np.concatenate(want)
    kept, errs = _compare_detections(got, want, 0, f"{name} float32 vs float64")
    x, _, _ = predictor.preprocess(ab)
    with torch.no_grad():
        d = max((p.double() - q).abs().max().item() for p, q in
                zip(yolo._fused_for_serving()(x), exact._fused(x.double())))
    for key, tol in (("box_err_px", max(F64_BOX_TOL, 2 * 32 * d)), ("score_err", max(1e-3, d))):
        check(errs[key] <= tol, f"{name} float32 vs float64: {key} {errs[key]} (maps {d} apart)")
    del exact
    half = yolo.predict_batched(ab, imgsz=RTDETR_IMGSZ, conf=0.25, half=True)
    check(half.shape == (2, 300, 6) and np.isfinite(half).all() and
          set(np.unique(half[..., 5])) <= set(range(len(WORLD_NAMES))), f"{name} half rows")
    kw, hkw = dict(imgsz=RTDETR_IMGSZ, conf=0.25), dict(imgsz=RTDETR_IMGSZ, conf=0.25, half=True)
    rates = {}
    for b in batches:
        rr = _rates(lambda: _img_per_s(yolo, frames[:b], kw, n=3),
                    lambda: _img_per_s(yolo, frames[:b], hkw, n=3))
        rates.update({f"img_per_s_b{b}_{k}": v for k, v in rr.items()})
    out = {"serve_world": name, "imgsz": RTDETR_IMGSZ, "vocabulary": WORLD_NAMES,
           "ab_confs": confs, "kept_per_frame": kept, **{f"{k}_vs_f64": v for k, v in errs.items()
                                                          if k != "embed_err"},
           "maps_vs_f64": d, "kept_per_frame_bf16_conf_0.25": (half[..., 4] > 0).sum(1).tolist(),
           **rates, "card": card}
    print(json.dumps(out))
    del yolo
    torch.cuda.empty_cache()
    return out


def _write_grounding(root: Path, seed: int) -> Path:
    """GROUNDING_FRAMES PNG frames and one COCO-style json with a caption a frame and 2-4
    boxes a frame, each named by a span of its caption. Returns the json's path."""
    n, (h, w) = GROUNDING_FRAMES
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True, exist_ok=True)
    images, anns = [], []
    words = ["person", "boat", "life jacket", "backpack", "car"]
    for i in range(n):
        small = rng.integers(0, 256, (h // 16, w // 16, 3), np.uint8)
        img = np.repeat(np.repeat(small, 16, 0), 16, 1)
        (root / "images" / f"{i:03d}.png").write_bytes(_png_file(img))
        picked = [words[j] for j in rng.choice(len(words), int(rng.integers(2, 5)), replace=False)]
        caption = "a " + " and a ".join(picked)
        images.append({"id": i, "file_name": f"{i:03d}.png", "height": h, "width": w,
                       "caption": caption})
        for word in picked:
            t0 = caption.index(word)
            bw, bh = rng.uniform(0.05, 0.4) * w, rng.uniform(0.05, 0.4) * h
            anns.append({"id": len(anns), "image_id": i, "tokens_positive": [[t0, t0 + len(word)]],
                         "bbox": [float(rng.uniform(0, w - bw)), float(rng.uniform(0, h - bh)),
                                  float(bw), float(bh)]})
    path = root / "grounding.json"
    path.write_text(json.dumps({"images": images, "annotations": anns}))
    return path


def phase_world_train(card: str, seed: int = 0) -> dict:
    """The yolov8s-world train step @640, batch 16, float32 and amp, and the grounding
    dataset through the loader into one forward (see the module docstring, phase 19)."""
    import torch

    from sar_yolo_tpu_torch.data.build import DataLoader
    from sar_yolo_tpu_torch.data.dataset import GroundingDataset
    from sar_yolo_tpu_torch.engine.trainer import DetectionTrainer
    steps = {}
    for label, kw in (("f32", {"amp": False}), ("amp", {})):
        tr = DetectionTrainer(dict(model="yolov8s-world.yaml", data="synthetic",
                                   imgsz=RTDETR_IMGSZ, batch=RTDETR_TRAIN_BATCH, seed=seed,
                                   optimizer="SGD", nbs=RTDETR_TRAIN_BATCH, warmup_epochs=0.0,
                                   workers=8, project="runs", name="chip_smoke_world",
                                   exist_ok=True, **kw))
        tr.setup()
        check(tr.model.text_embeddings.shape[0] == 3, "world trainer: text rows")
        batch = next(iter(tr.train_loader))
        _, items = tr.train_step(batch)
        items = items.cpu().numpy()
        check(np.isfinite(items).all(), f"world {label}: items {items}")
        steps[label] = {"items": items.tolist(), **_timed_steps(tr, batch)}
        world_model = tr.model
        del tr, batch
        torch.cuda.empty_cache()
    root = Path("runs") / "chip_smoke_grounding"
    shutil.rmtree(root, ignore_errors=True)
    path = _write_grounding(root, seed)
    ds = GroundingDataset(str(root / "images"), str(path), imgsz=RTDETR_IMGSZ, max_labels=16)
    texts = sorted({t[0] for lb in ds.labels for t in lb["texts"]})
    t0 = time.perf_counter()
    batches = list(DataLoader(ds, 4, workers=4, shuffle=False, drop_last=False))
    load_s = time.perf_counter() - t0
    n_boxes = sum(int(b["mask"].sum()) for b in batches)
    check(len(ds) == GROUNDING_FRAMES[0] and n_boxes == sum(len(lb["cls"]) for lb in ds.labels)
          and batches[0]["img"].shape == (4, RTDETR_IMGSZ, RTDETR_IMGSZ, 3),
          f"grounding loader: {len(ds)} frames, {n_boxes} boxes")
    with torch.no_grad():
        x = torch.from_numpy(batches[0]["img"]).cuda().permute(0, 3, 1, 2).float() / 255
        maps = world_model.eval()(x.to(world_model.compute_dtype))
    check(all(torch.isfinite(m).all() for m in maps), "world forward on the grounding batch")
    shutil.rmtree(root, ignore_errors=True)
    out = {"world_train_step": f"yolov8s-world@{RTDETR_IMGSZ} b{RTDETR_TRAIN_BATCH} synthetic "
           "nc 3", "loss_names": "box cls dfl", **steps,
           "grounding": {"frames": len(ds), "boxes": n_boxes, "phrases": texts,
                         "loader_s": load_s}, "card": card}
    print(json.dumps(out))
    return out


def phase_rtdetr_world(card: str) -> dict:
    """Phase 19: RT-DETR and YOLO-World served, trained and validated; no graph of theirs has
    an A2C2f block. Returns the launches by path."""
    import torch

    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention, reset_launches
    laps = {}
    t = time.perf_counter()
    reset_launches()
    for name, batches, min_e2e in RTDETR_SERVE:
        phase_rtdetr_serve(name, batches, min_e2e, card)
    laps["rtdetr_serve"], t = time.perf_counter() - t, time.perf_counter()
    phase_rtdetr_train(card)
    laps["rtdetr_train_val"], t = time.perf_counter() - t, time.perf_counter()
    for name, batches in WORLD_SERVE:
        phase_world_serve(name, batches, card)
    laps["world_serve"], t = time.perf_counter() - t, time.perf_counter()
    phase_world_train(card)
    laps["world_train"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    by = dict(flash_area_attention.launches_by_dtype)
    check(by == {"float32": 0, "bfloat16": 0}, f"phase 19: attention kernel launches {by}")
    print(json.dumps({"phase_rtdetr_world_s": laps, "kernel_launches_by_dtype": by}))
    return {f"serve rtdetr-l@{RTDETR_IMGSZ} b1/b8/b128, rtdetr-resnet50 and yolov8n-rtdetr b8, "
            "f32 and bf16": 0,
            f"rtdetr-l train step @{RTDETR_IMGSZ} b{RTDETR_TRAIN_BATCH}, f32 and amp": 0,
            "RTDETR.train / val / YOLO(checkpoint) rtdetr-l": 0,
            "serve yolov8s-world b1/b8, yolov8s-worldv2 b8, f32 and bf16": 0,
            f"yolov8s-world train step @{RTDETR_IMGSZ} b{RTDETR_TRAIN_BATCH}, f32 and amp; "
            "grounding loader": 0}


# ---- phase 20: int8 serving, data parallelism, sharded serving -------------------------------

INT8_IMGSZ = 640
INT8_SERVE = (("yolov13n-JDE.yaml", True, (1, 8)), ("yolov13l-JDE.yaml", "auto", (8,)))
INT8_BATCH = 8            # the batch of the kernel's shapes and of the kernels line
PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8 tensor-core rate
MAPS_INT8_TOL = 1e-6      # the kernel path's head maps against the plain int8 path, of their max
FLOAT64_DDP_TOL = 1e-6    # the float64 2-rank step against the float64 plain step, of each
                          # tensor's largest magnitude (a wrong gradient: O(1))
PROBE_SEED = 7            # the probe loss's normal weights (`probe_functional`)
FLOAT64_ZERO = 1e-9       # a float64 gradient under this much of the model's largest is a zero
                          # that rounding left


def phase_int8_build():
    """The int8 path's two kernels (built in phase 2, side by side with the attention kernel):
    ptxas's registers and spills of each instantiation (a spill fails); the conv's SASS must
    hold int8 tensor-core instructions (IMMA or IGMMA) and no IDP4A."""
    import os
    import re
    import shutil

    from sar_yolo_tpu_torch.ops.cuda import int8_conv as ic
    t0 = time.perf_counter()
    (conv_path, conv_log), (quant_path, quant_log) = ic.build()
    print(f"build: {conv_path.name}, {quant_path.name} in {time.perf_counter() - t0:.2f} s "
          "(cached from phase 2)")
    spills = []
    for log in (conv_log, quant_log):
        entry = None
        for line in log.splitlines():
            if m := re.search(r"Compiling entry function '.*int8_conv_kernel"
                              r"ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", line):
                wf, wp, mf, np_, cb = map(int, m.groups())
                entry = f"int8_conv tile {wf * mf * 16}x{wp * np_ * 8} {cb}-byte copies"
            elif m := re.search(r"Compiling entry function '.*(int8_\w+?_kernel)I(\w+?)E", line):
                entry = f"{m.group(1)} " + {"f": "float32", "13__nv_bfloat16": "bfloat16"}.get(
                    m.group(2), m.group(2))
            if entry and ("registers" in line or "spill" in line):
                print(f"  {entry}: {line.strip().removeprefix('ptxas info    : ')}")
        spills += [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
    check(spills and max(spills) == 0, f"register spills in the int8 build: {spills}")
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(conv_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts = {op: len(re.findall(pattern, sass)) for op, pattern in (
        ("IMMA", r"\bIMMA[.\s]"), ("IGMMA", r"\bIGMMA[.\s]"), ("IDP4A", r"\bIDP\.?4A"))}
    print(f"  int8_conv SASS: {counts}")
    check(counts["IMMA"] + counts["IGMMA"] > 0 and counts["IDP4A"] == 0,
          f"int8_conv SASS: {counts}; expected tensor-core instructions and no IDP4A")


@contextlib.contextmanager
def _int8_calls(calls: list):
    """While active, each Int8Conv2d forward appends (x, pad_to, (xq, wq, sx, sw, bias, stride,
    padding, dilation, dtype)) to `calls`: its int8_quantize input and its int8_conv call."""
    from sar_yolo_tpu_torch.ops.cuda import int8_conv as ic
    quantize, launch = ic.int8_quantize, ic.int8_conv
    pending = []

    def record_quantize(x, pad_to):
        pending.append((x, pad_to))
        return quantize(x, pad_to)

    def record(*args):
        calls.append((*pending.pop(), args))
        return launch(*args)
    ic.int8_quantize, ic.int8_conv = record_quantize, record
    try:
        yield calls
    finally:
        ic.int8_quantize, ic.int8_conv = quantize, launch


@contextlib.contextmanager
def _plain_int8():
    """While active, int8_quantize and int8_conv run their plain versions on CUDA tensors too
    (the comparison's launches, not counted)."""
    from sar_yolo_tpu_torch.ops.cuda import int8_conv as ic
    quantize, launch = ic.int8_quantize, ic.int8_conv
    ic.int8_quantize, ic.int8_conv = ic.int8_quantize_plain, ic.int8_conv_plain
    try:
        yield
    finally:
        ic.int8_quantize, ic.int8_conv = quantize, launch


def _unfold_int8(xq, kh: int, stride: int, pad: int, dil: int, k_pad: int):
    """The im2col matrix (M, K) of NHWC int8 xq, K zero-padded to k_pad (torch._int_mm's
    operand)."""
    import torch
    from torch.nn import functional as F
    xp = F.pad(xq, (0, 0, pad, pad, pad, pad))
    B, H, W, C = xp.shape
    ho, wo = (H - dil * (kh - 1) - 1) // stride + 1, (W - dil * (kh - 1) - 1) // stride + 1
    sb, sh, sw, sc = xp.stride()
    cols = xp.as_strided((B, ho, wo, kh, kh, C), (sb, stride * sh, stride * sw, dil * sh,
                                                  dil * sw, sc)).reshape(B * ho * wo, -1)
    return F.pad(cols, (0, k_pad - cols.shape[1])) if k_pad > cols.shape[1] else cols


def _int8_shape_rows(calls: list, label: str) -> list:
    """Every call of one forward: the quantize kernel's xq and sx against the plain version's
    (equal, byte for byte; each shape's row keeps the largest differences of its calls) and
    the conv kernel's int32 sums against the plain version's (equal); at each distinct shape
    the float32 and bf16 epilogues against the plain
    version's, the conv's tile and times (CUDA-graph replay of 20 launches): the quantize
    kernel and its plain version, the conv kernel, its plain version, torch._int_mm on the
    unfolded matrices without and with the unfold, cuDNN's bf16 convolution of the same
    shape; the bounds (conv: bytes or operations; quantize: bytes)."""
    import torch
    from torch.nn import functional as F

    from sar_yolo_tpu_torch.ops.cuda import int8_conv as ic
    rows, seen = [], {}
    for i, (x, pad_to, (xq, wq, sx, sw, bias, stride, pad, dil, dtype)) in enumerate(calls):
        kq, ksx = ic.int8_quantize(x, pad_to)
        pq, psx = ic.int8_quantize_plain(x, pad_to)
        xq_err = (kq.int() - pq.int()).abs().max().item()
        sx_err = (ksx - psx).abs().max().item()
        check(torch.equal(kq, pq) and torch.equal(ksx.view(torch.int32), psx.view(torch.int32)),
              f"{label} call {i} {tuple(x.shape)} {x.dtype}: the quantize kernel's xq differs "
              f"from the plain version's in {(kq != pq).sum().item()} values (by up to "
              f"{xq_err}), sx by {sx_err}")
        sums = ic.int8_conv_sums(xq, wq, stride, pad, dil)
        ref = ic.conv_sums_plain(xq, wq, stride, pad, dil)
        check(torch.equal(sums.double(), ref), f"{label} call {i}: int32 sums differ from the "
              f"plain version's by {(sums.double() - ref).abs().max().item()}")
        key = (tuple(x.shape), x.dtype, tuple(wq.shape), stride, pad, dil)
        if key in seen:  # the shape's row keeps the largest quantize errors of its calls
            row = seen[key]
            row["quantize_xq_abs_err"] = max(row["quantize_xq_abs_err"], xq_err)
            row["quantize_sx_abs_err"] = max(row["quantize_sx_abs_err"], sx_err)
            rows.append(row)
            continue
        errs, abs_err = {}, 0.0
        for dt in (torch.float32, torch.bfloat16):
            y = ic.int8_conv(xq, wq, sx, sw, bias, stride, pad, dil, dt).float()
            want = ic.rescale(ref, sx, sw, bias, dt).float()
            errs[str(dt).removeprefix("torch.")] = ((y - want).abs().max() /
                                                     want.abs().max()).item()
            abs_err = max(abs_err, (y - want).abs().max().item())
        check(errs["float32"] <= 1e-6 and errs["bfloat16"] <= 2 ** -8,
              f"{label} {key}: epilogue off the plain version's by {errs}")
        B, H, W, C = xq.shape
        N, kh, kw, _ = wq.shape
        ho, wo = sums.shape[2:]
        M, K = B * ho * wo, kh * kw * C
        k8, n8 = -(-K // 16) * 16, -(-N // 8) * 8
        wmat = F.pad(wq.reshape(N, K), (0, k8 - K, 0, n8 - N)).t()  # (K, N) column-major
        cols = _unfold_int8(xq, kh, stride, pad, dil, k8)
        c_in = x.shape[1]
        xb = xq[..., :c_in].permute(0, 3, 1, 2).to(torch.bfloat16)
        wb = wq[..., :c_in].permute(0, 3, 1, 2).to(torch.bfloat16)
        times = {
            "quantize_ms": device_ms(lambda: ic.int8_quantize(x, pad_to), reps=3),
            "quantize_plain_ms": device_ms(lambda: ic.int8_quantize_plain(x, pad_to), reps=3),
            "kernel_ms": device_ms(lambda: ic.int8_conv(xq, wq, sx, sw, bias, stride, pad, dil,
                                                        dtype), reps=3),
            "plain_ms": device_ms(lambda: ic.int8_conv_plain(xq, wq, sx, sw, bias, stride, pad,
                                                             dil, dtype), reps=3),
            "int_mm_ms": device_ms(lambda: torch._int_mm(cols, wmat), reps=3),
            "int_mm_with_unfold_ms": device_ms(lambda: torch._int_mm(
                _unfold_int8(xq, kh, stride, pad, dil, k8), wmat), reps=3),
            "cudnn_bf16_ms": device_ms(lambda: F.conv2d(xb, wb, None, stride, pad, dil), reps=3)}
        nbytes = B * H * W * c_in + N * kh * kw * c_in + \
            M * N * torch.empty((), dtype=dtype).element_size() + 4 * (B + 2 * N)
        t_ops, t_bytes = 2 * M * N * K / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        q_bytes = x.numel() * x.element_size() + xq.numel() + 4 * B
        row = {"x": list(x.shape), "x_dtype": str(x.dtype).removeprefix("torch."),
               "w": list(wq.shape), "stride": stride, "pad": pad, "dil": dil, "M": M, "N": N,
               "K": K, "tile": "x".join(map(str, ic.plan(xq, wq, stride, pad, dil)["tile"])),
               "epilogue_rel_err": errs, "epilogue_abs_err": abs_err,
               "quantize_xq_abs_err": xq_err, "quantize_sx_abs_err": sx_err, **times,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "quantize_bound_ms": q_bytes / PEAK_BYTES * 1e3}
        seen[key] = row
        rows.append(row)
        print(json.dumps({"int8_conv_shape": label, **row}))
    return rows


PROFILE_TRIES = 3  # traces taken of one call before a trace that lost records fails


def _complete_trace(fn, names: tuple, launched) -> tuple:
    """(torch.profiler's `key_averages()` (CPU and CUDA activities) over fn(), the counts of
    each trace taken): the trace is taken again, up to PROFILE_TRIES times, while it shows
    that it lost device records, that is fewer kernels named by `names` on the device than
    the port's wrappers counted (`launched()`, read before and after). CUPTI can drop
    activity records: one run of phase 20 saw 91 of a forward's 103 launches of each int8
    kernel (12 of each missing, spread over every conv tiling) while its wrappers counted
    103. A drop only lowers the counts, so a complete trace is one that shows every counted
    launch. Fails if none is. (The runtime's launch calls are no measure of completeness: the
    `.pt2` program's traces hold 9 more `cudaLaunch*` calls than kernels, in every take.)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        n0 = launched()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        seen.append({"named": sum(ev.count for ev in events if ev.device_type == DeviceType.CUDA
                                  and any(n in ev.key for n in names)),
                     "counted": launched() - n0})
        if seen[-1]["named"] >= seen[-1]["counted"]:
            return events, seen
    check(False, f"every one of {PROFILE_TRIES} profiler traces lost device records (kernels "
          f"named {names} against the wrappers' count): {seen}")


def _int8_device_launches(model, x) -> dict:
    """Device launches (torch.profiler's CUDA events: kernels, copies, memsets) of one forward
    of `model` on x, and of its quantized convolutions alone, each run on the input it
    receives in that forward; the latter by kernel name and per quantized convolution."""
    import collections

    import torch
    from torch.autograd import DeviceType

    from sar_yolo_tpu_torch.nn.modules.conv import Int8Conv2d
    from sar_yolo_tpu_torch.ops.cuda import int8_conv as ic
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append((m, a[0])))
             for m in model.modules() if isinstance(m, Int8Conv2d)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()

    def device_events(fn) -> collections.Counter:
        with torch.no_grad():
            events, traces = _complete_trace(fn, ("int8_quantize", "int8_conv"), lambda: (
                ic.int8_conv.launches + ic.int8_quantize.launches))
        return collections.Counter({ev.key: ev.count for ev in events
                                    if ev.device_type == DeviceType.CUDA}), traces
    forward, forward_traces = device_events(lambda: model(x))
    convs, conv_traces = device_events(lambda: [m(xi) for m, xi in seen])
    check(sum(convs.values()) > 0, "the profiler saw no device event in the quantized convs")
    return {"forward": sum(forward.values()), "quantized_convs": len(seen),
            "in_quantized_convs": sum(convs.values()),
            "per_quantized_conv": sum(convs.values()) / len(seen),
            "by_kernel": {k[:60]: v for k, v in convs.most_common()},
            "profiler_traces": {"forward": forward_traces, "quantized_convs": conv_traces}}


def _maps_distance(a, b) -> float:
    """max |a - b| over the head maps, over max |b|."""
    from torch.utils._pytree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return max((x.double() - y.double()).abs().max().item() for x, y in zip(la, lb)) / \
        max(y.double().abs().max().item() for y in lb)


def phase_int8_serve(name: str, req, batches, card: str, seed: int = 0) -> dict:
    """int8 serving through `predict_batched`: the launches a forward (one int8_quantize and
    one int8_conv call a quantized conv, one area-attention launch an AAttn), the kernel
    path against the plain int8 path (head maps; rows at phase 4's `_ab_conf` threshold,
    equal), each path's distance from the float32 fused model, img/s int8 and float32 in
    turns; the kernels at every call of one forward at the largest batch, and the profiler's
    device launches a quantized conv there."""
    import torch

    from sar_yolo_tpu_torch.nn.modules.block import AAttn
    from sar_yolo_tpu_torch.nn.modules.conv import Int8Conv2d
    from sar_yolo_tpu_torch.ops.cuda import int8_conv as ic
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    torch.backends.cudnn.deterministic = True
    yolo = _perturbed_yolo(name, seed, INT8_IMGSZ)
    frames = np.random.default_rng(seed).integers(0, 256, (max(batches), 720, 1280, 3), np.uint8)
    kw = dict(imgsz=INT8_IMGSZ, int8=req)
    pred = yolo._get_predictor(dict(kw))
    check(pred.args.int8 is True and pred.model.quant == "int8",
          f"{name}: int8={req!r} did not quantize (scale {yolo.meta['scale']})")
    n_q = sum(isinstance(m, Int8Conv2d) for m in pred.model.modules())
    # one area-attention launch an AAttn a forward (8 at scale n, 16 at l)
    n_attn = sum(isinstance(m, AAttn) for m in pred.model.modules()) if LAUNCHES_PER_FORWARD else 0
    x, _, _ = pred.preprocess(frames)
    with torch.no_grad():
        maps_k = pred.model(x)
        with _plain_int8():
            maps_p = pred.model(x)
        maps_f = yolo._fused_for_serving()(x)
        preds, _ = pred.decode(maps_k)
    nc = yolo.meta["nc"]
    conf = _ab_conf(preds[..., 4:4 + nc].amax(-1).double().cpu().numpy(), 300)[0]
    out = {"int8_serve": name, "int8": req, "scale": yolo.meta["scale"], "imgsz": INT8_IMGSZ,
           "quantized_convs": n_q, "conf": conf,
           "maps_kernel_vs_plain_int8": _maps_distance(maps_k, maps_p),
           "maps_kernel_vs_f32": _maps_distance(maps_k, maps_f),
           "maps_plain_int8_vs_f32": _maps_distance(maps_p, maps_f)}
    check(out["maps_kernel_vs_plain_int8"] <= MAPS_INT8_TOL,
          f"{name}: int8 kernel path's maps {out['maps_kernel_vs_plain_int8']} off the plain's")
    launches = {}
    for b in batches:
        yolo.predict_batched(frames[:b], conf=conf, **kw)  # warm
        ic.reset_launches()
        flash_area_attention.launches = 0
        got = yolo.predict_batched(frames[:b], conf=conf, **kw)
        launches[b] = (ic.int8_conv.launches, ic.int8_quantize.launches,
                       flash_area_attention.launches)
        n_k = n_q if x.is_cuda else 0  # the CPU: the plain versions
        check(launches[b] == (n_k, n_k, n_attn), f"{name} b{b}: (int8_conv, int8_quantize, "
              f"attention) launches {launches[b]}, expected {(n_k, n_k, n_attn)}")
        with _plain_int8():
            want = yolo.predict_batched(frames[:b], conf=conf, **kw)
        check(np.array_equal(got, want), f"{name} b{b}: the int8 kernel path's rows differ from "
              f"the plain int8 path's by {np.abs(got - want).max()}")
        out[f"kept_per_frame_b{b}"] = (got[..., 4] > 0).sum(1).tolist()
        rates = _rates(lambda: _img_per_s(yolo, frames[:b], dict(imgsz=INT8_IMGSZ, conf=conf)),
                       lambda: _img_per_s(yolo, frames[:b], dict(conf=conf, **kw)))
        out[f"img_per_s_b{b}"] = {"float32": rates["f32"], "int8": rates["bf16"],
                                  "float32_runs": rates["f32_runs"], "int8_runs": rates["bf16_runs"]}
    out["launches_int8_conv_quantize_attention"] = {f"b{b}": v for b, v in launches.items()}
    xb = pred.preprocess(frames[:INT8_BATCH])[0]
    if x.is_cuda and name == INT8_SERVE[0][0]:
        out["device_launches"] = launched = _int8_device_launches(pred.model, xb)
        print(json.dumps({"int8_device_launches": name, **launched}))
        named = {k: v for k, v in launched["by_kernel"].items() if "int8_" in k}
        check(sum(v for k, v in named.items() if "int8_quantize" in k) == n_q and
              sum(v for k, v in named.items() if "int8_conv" in k) == n_q,
              f"{name}: the profiler saw {named}, not {n_q} launches of each kernel")
        check(launched["per_quantized_conv"] <= 3, f"{name}: "
              f"{launched['per_quantized_conv']} device launches a quantized conv")
    calls = []
    with _int8_calls(calls), torch.no_grad():
        pred.model(xb)
    check(len(calls) == n_q, f"{name}: {len(calls)} int8 calls in a forward, expected {n_q}")
    shape_rows = _int8_shape_rows(calls, f"{name}@{INT8_IMGSZ} b{INT8_BATCH}")
    print(json.dumps(out))
    return {"rows": shape_rows, "launches": launches}


def _ddp_step(tr, batch) -> tuple:
    """One step through the trainer's data-parallel path: (loss items, gradients, state after
    the update incl. the EMA)."""
    b = tr.to_device(batch)
    total, items, cb = tr.loss(*tr.gather_global(tr.forward(b), b))
    total.backward()
    grads = {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()}
    tr.update(cb)
    state = {**{k: v.detach().clone() for k, v in tr.model.state_dict().items()},
             **{f"ema.{n}": e.clone() for (n, _), e in zip(tr.model.named_parameters(), tr.ema)},
             "cb_counts": tr.cb_counts.clone()}
    return items.detach(), grads, state


def _train_steps_runs(rank: int, device, runs: list) -> list:
    """`train_steps(rank, device, *args)` for each args of `runs`, in turn, in one set of
    spawned ranks (one process start-up and one process group for all of them)."""
    from sar_yolo_tpu_torch.engine.trainer import train_steps
    return [train_steps(rank, device, *args) for args in runs]


def phase_ddp(card: str, seed: int = 0, device: str = "cuda:0") -> dict:
    """The yolov13n-JDE @640 train step with global batch 16 under data parallelism: one NCCL
    rank against the plain step (tensor for tensor, its launches counted), two gloo ranks
    on cuda:0 (8 images each) against the plain step: in float64 tensor by tensor, in
    float32 within `_train_ab`'s limits over the plain path's own noise (the step's items
    and gradient L2, the probe loss's gradients tensor by tensor); step times, the bytes
    gathered for the loss and the share of the model's forward collectives."""
    import torch

    from sar_yolo_tpu_torch.cfg.default import DEFAULT_CFG
    from sar_yolo_tpu_torch.engine.trainer import JDETrainer, probe_functional
    from sar_yolo_tpu_torch.nn.modules.conv import Dropout
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    from sar_yolo_tpu_torch.parallel import mesh
    torch.backends.cudnn.deterministic = True
    laps, t = {}, time.perf_counter()
    ab = dict(model="yolov13n-JDE.yaml", data="synthetic", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH,
              seed=seed, optimizer="SGD", nbs=TRAIN_BATCH, warmup_epochs=0.0, amp=False,
              val=False, save=False, project="runs/chip_smoke_ddp")
    mesh.init_distributed(device, None, f"tcp://127.0.0.1:{mesh.free_port()}", 0, 1)
    # the plain step's own float32 noise, none of it from the tested path: the step on the
    # batch's images in other orders (the same sums in another order, as two ranks take
    # them; rounding near a tie of the assigner or the miner decides another way), and the
    # step on each half of the batch (a rank's shapes) in float32 against float64
    B = TRAIN_BATCH
    orders = {"reversed": lambda v: v[::-1].copy(),
              **{f"rolled_{k}": (lambda v, k=k: np.roll(v, k, 0)) for k in (B // 4, B // 2)}}
    halves = {"share_a": lambda v: v[:B // 2], "share_b": lambda v: v[B // 2:]}
    half = {"batch": B // 2, "nbs": B // 2}
    trainers = {}
    for label, extra in (("plain", {}), ("rerun", {}), ("rounded", {}), ("f64", {}),
                         *((k, {}) for k in orders),
                         *((k + s, half) for k in halves for s in ("", "64")),
                         ("ddp", {"mesh_shape": [1]})):
        tr = trainers[label] = JDETrainer({**ab, **extra}, device=device)
        tr.setup()
        for m in tr.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    # _train_ab's plain C (the attention rounded from float64) and the plain step in float64:
    # each float32 result's distance from it is float32's floor
    _set_flash(trainers["rounded"], False)
    for k in ("f64", *(h + "64" for h in halves)):
        _set_flash(trainers[k], False)
        trainers[k].model.double()
        trainers[k].ema = [e.double() for e in trainers[k].ema]
    check(trainers["ddp"].ddp is not None and trainers["plain"].ddp is None,
          "the mesh_shape=[1] trainer is not wrapped in DDP")
    start = {k: v.detach().cpu().clone() for k, v in trainers["plain"].model.state_dict().items()}
    trainers["plain"].train_loader.set_epoch(0)
    batch = next(iter(trainers["plain"].train_loader))

    def rows(pick):
        return {k: pick(v) if isinstance(v, np.ndarray) and len(v) == B else v
                for k, v in batch.items()}
    inputs = {**{k: rows(f) for k, f in orders.items()},
              **{k + s: rows(f) for k, f in halves.items() for s in ("", "64")}}
    res = {}
    for k, tr in trainers.items():
        flash_area_attention.launches = 0
        with _RoundedAttention() if k == "rounded" else contextlib.nullcontext():
            res[k] = _ddp_step(tr, inputs.get(k, batch))
        if k == "ddp":
            ddp1_launches = flash_area_attention.launches
    check(ddp1_launches == LAUNCHES_PER_FORWARD,
          f"the 1-rank NCCL DDP step made {ddp1_launches} area-attention launches, expected "
          f"{LAUNCHES_PER_FORWARD}")
    (ia, ga, sa), (ib, gb, sb), (idd, gd, sd) = res["plain"], res["rerun"], res["ddp"]
    (ic, gc, sc), (i64, g64, s64) = res["rounded"], res["f64"]
    # each noise sample: (items or None, gradients and state against the plain step's)
    noise = {"rerun": (ib, gb, sb, ga, sa), "rounded_attention": (ic, gc, sc, ga, sa),
             "float64": (i64, g64, s64, ga, sa),
             **{k: (*res[k], ga, sa) for k in orders},
             **{k: (None, res[k][1], res[k][2], res[k + "64"][1], res[k + "64"][2])
                for k in halves}}

    def worst(x, y):
        return max((x[k].double() - y[k].double()).abs().max().item() for k in y)

    one = {"items_equal": bool(torch.equal(idd, ia)), "grads_max_diff": worst(gd, ga),
           "state_max_diff": worst(sd, sa), "rerun_grads_max_diff": worst(gb, ga),
           "rerun_state_max_diff": worst(sb, sa)}
    check(torch.equal(ib, ia) or one["rerun_grads_max_diff"] > 0, "plain rerun inconsistent")
    check(torch.equal(idd, ia) and one["grads_max_diff"] <= one["rerun_grads_max_diff"]
          and one["state_max_diff"] <= one["rerun_state_max_diff"],
          f"the 1-rank NCCL DDP step differs from the plain step: {one}")
    t_plain = _timed_steps(trainers["plain"], batch, n=3, warmup=1)["step_ms"]
    t_ddp1 = _timed_steps(trainers["ddp"], batch, n=3, warmup=1)["step_ms"]
    # the probe's gradients at the start weights: the plain step, its rerun, its attention
    # rounded from float64, float64, and the batch in other orders (r in the same order)
    probe = {}
    for k in ("plain", "rerun", "rounded", "f64", *orders):
        tr = trainers[k]
        tr.model.load_state_dict(start)
        tr.model.zero_grad(set_to_none=True)
        b = tr.to_device(inputs.get(k, batch))
        idx = torch.from_numpy(orders[k](np.arange(B))).to(device) if k in orders else None
        with _RoundedAttention() if k == "rounded" else contextlib.nullcontext():
            probe_functional(tr.forward(b), PROBE_SEED, idx).backward()
        probe[k] = {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()}
    del trainers
    mesh.destroy()
    torch.cuda.empty_cache()
    laps["one_process"], t = time.perf_counter() - t, time.perf_counter()
    # one pair of gloo ranks on cuda:0 runs the three two-rank steps in turn: the float32
    # task-loss step (then 3 timed), the float32 probe step, and the float64 step, which holds
    # the algorithm without float32's rounding against the plain step in float64: each
    # gradient and each tensor after the update within FLOAT64_DDP_TOL of its own largest
    # magnitude, or of FLOAT64_ZERO of the model's largest gradient or update (a gradient that
    # is zero but for rounding: BN biases whose shift a later train-mode BN removes)
    cfg2 = {**ab, "mesh_shape": [2]}
    two, two_probe, two64 = mesh.spawn(_train_steps_runs, ([
        (JDETrainer, cfg2, [batch], start, 3), (JDETrainer, cfg2, [batch], start, 0, False,
                                                PROBE_SEED),
        (JDETrainer, cfg2, [batch], start, 0, True)],), devices=[device, device], backend="gloo")
    two_probe = two_probe["grads"][0]
    laps["two_ranks"] = time.perf_counter() - t
    check(two["rank_spread"] == 0.0, f"the two ranks' replicas differ by {two['rank_spread']}")

    def dist(x, y):
        return (x.double().cpu() - y.double().cpu()).abs().max().item()
    g64_max = max(g.abs().max().item() for g in g64.values())
    step64_max = max(dist(s64[n], start[n]) for n in g64)
    exact = [(f"grad {n}", dist(two64["grads"][0][n], g), g.abs().max().item(), g64_max)
             for n, g in g64.items()]
    exact += [(k, dist(two64["state"][k], v), v.abs().max().item(), step64_max)
              for k, v in s64.items() if k in two64["state"] and v.is_floating_point()]
    exact_rows = sorted((d / max(own, FLOAT64_ZERO * top) / FLOAT64_DDP_TOL, k, d, own / top)
                        for k, d, own, top in exact)
    check(two["launches_by_rank"] == [[LAUNCHES_PER_FORWARD]] * 2,
          f"area-attention launches a step by rank {two['launches_by_rank']}")
    # float32, the train step: in this model at its start the float32 rounding of any path
    # moves near-ties of the assigner and the miner, and the gradient with them (the plain
    # step lies ~1% from its float64 step, relative L2), so the step is held by its loss
    # items and its gradient's L2 distance, against the spread of the plain step's own noise
    # samples (its rerun, its attention rounded from float64, its distance from the float64
    # step, the other orders, each half against float64), or 1e-5 of the items; each
    # gradient is held on the probe below, which has no such decision
    a_items = ia.cpu().numpy()
    spread = np.max([np.abs(t.double().cpu().numpy() - a_items)
                     for t, *_ in noise.values() if t is not None], 0)
    scale = np.abs(a_items)
    scale[3] = max(scale[3], DEFAULT_CFG["clr"])  # the triplet item: its gain's scale
    item_ratio = (np.abs(two["items"][0].numpy() - a_items) /
                  np.maximum(2 * spread, 1e-5 * scale)).max()

    def flat(g):
        return torch.cat([g[n].double().cpu().flatten() for n in ga])

    def rel_l2(g, ref):
        return (flat(g) - flat(ref)).norm().item() / flat(ref).norm().item()
    g2, g2_64 = two["grads"][0], two64["grads"][0]
    l2 = {k: rel_l2(g, ref) for k, (_, g, _, ref, _) in noise.items()}
    l2_ratio = rel_l2(g2, ga) / max(2 * max(l2.values()), 1e-30)
    l2["two_ranks"] = rel_l2(g2, ga)
    l2["two_ranks_vs_its_float64"] = rel_l2(g2, g2_64)  # reported, in no limit
    # the train step's gradients, tensor by tensor, against the same samples (reported only)
    g_max = max(g.abs().max().item() for g in ga.values())
    step_terms = {n: {k: dist(g[n], ref[n]) for k, (_, g, _, ref, _) in noise.items()}
                  for n in ga}
    step_rows = sorted((dist(g2[n], g) / max(4 * max(step_terms[n].values()),
                                             1e-4 * g.abs().max().item(), 1e-6 * g_max), n)
                       for n, g in ga.items())
    # float32, the probe: each gradient within _train_ab's limits over the spread of the
    # plain probe's rerun, its attention rounded from float64, its distance from float64 and
    # the other orders, or 1e-4 of its largest magnitude, 1e-6 of the model's largest
    pa = probe["plain"]
    p_max = max(g.abs().max().item() for g in pa.values())
    probe_terms = {n: {k: dist(probe[k][n], pa[n]) for k in probe if k != "plain"} for n in pa}
    grad_rows = sorted((dist(two_probe[n], g) / max(4 * max(probe_terms[n].values()),
                                                    1e-4 * g.abs().max().item(), 1e-6 * p_max),
                        n) for n, g in pa.items())
    probe_l2 = {k: rel_l2(probe[k], pa) for k in probe if k != "plain"}
    probe_l2_ratio = rel_l2(two_probe, pa) / max(2 * max(probe_l2.values()), 1e-30)
    probe_l2["two_ranks"] = rel_l2(two_probe, pa)
    out = {"ddp_s": laps, "ddp_1rank_nccl": one, "plain_step_ms": t_plain,
           "ddp_1rank_step_ms": t_ddp1,
           "ddp_2rank_gloo": {"items": two["items"][0].tolist(), "items_plain": ia.tolist(),
                              "items_rounding_spread": spread.tolist(),
                              "items_err_over_limit": float(item_ratio),
                              "float64_two_ranks_vs_plain_worst": [
                                  {"name": k, "err_over_limit": r, "max_abs_diff": d,
                                   "own_max_over_model_max": o}
                                  for r, k, d, o in exact_rows[-5:]],
                              "float64_under_zero_floor": sum(o < FLOAT64_ZERO
                                                              for _, _, _, o in exact_rows),
                              "grad_rel_l2": l2, "grad_l2_over_limit": l2_ratio,
                              "step_grad_worst_reported": [
                                  {"param": n, "err_over_4x_spread": r,
                                   "err": dist(g2[n], ga[n]), **step_terms[n],
                                   "two_ranks_vs_its_float64": dist(g2[n], g2_64[n])}
                                  for r, n in step_rows[-3:]],
                              "probe_grad_rel_l2": probe_l2,
                              "probe_grad_l2_over_limit": probe_l2_ratio,
                              "probe_grad_worst": [{"param": n, "err_over_limit": r,
                                                    "err": dist(two_probe[n], pa[n]),
                                                    **probe_terms[n]}
                                                   for r, n in grad_rows[-3:]],
                              "launches_by_rank": two["launches_by_rank"],
                              "step_ms": two["step_ms"],
                              "collective_forward_ms": two["collective_ms"],
                              "collective_forward_share": statistics.median(two["collective_ms"]) /
                              statistics.median(two["step_ms"]),
                              "gathered_bytes_per_rank": two["gathered_bytes"]}}
    print(json.dumps(out))
    check(exact_rows[-1][0] <= 1, f"the float64 2-rank step's {exact_rows[-1][1]} off the "
          f"float64 plain step's by {exact_rows[-1][0]:.3g}x the limit")
    check(item_ratio <= 1, f"2-rank step's loss items off by {item_ratio:.3g}x the limit")
    check(l2_ratio <= 1, f"2-rank step's gradient {l2['two_ranks']:.3g} from the plain one's "
          f"(L2, relative), over twice the spread {l2}")
    check(probe_l2_ratio <= 1, f"2-rank probe gradient {probe_l2['two_ranks']:.3g} from the "
          f"plain one's (L2, relative), over twice the spread {probe_l2}")
    check(grad_rows[-1][0] <= 1, f"2-rank probe's gradient of {grad_rows[-1][1]} off by "
          f"{grad_rows[-1][0]:.3g}x the limit")
    return {f"DDP train step yolov13n-JDE@{TRAIN_IMGSZ} b{TRAIN_BATCH}, 1 NCCL rank":
            ddp1_launches, f"DDP train step, 2 gloo ranks on cuda:0 (each rank)":
            two["launches_by_rank"][0][0]}


def phase_sharded_serve(seed: int = 0):
    """`predict_batched(mesh_shape=[1])` equals the unsharded call; a mesh of more devices
    than the machine has raises ValueError."""
    import torch
    yolo = _perturbed_yolo("yolov13n-JDE.yaml", seed, INT8_IMGSZ)
    frames = np.random.default_rng(seed).integers(0, 256, (INT8_BATCH, 720, 1280, 3), np.uint8)
    kw = dict(imgsz=INT8_IMGSZ, conf=0.01)
    one = yolo.predict_batched(frames, **kw)
    check(np.array_equal(yolo.predict_batched(frames, mesh_shape=[1], **kw), one),
          "predict_batched(mesh_shape=[1]) differs from the unsharded call")
    n = torch.cuda.device_count()
    raised = False
    try:
        yolo.predict_batched(frames, mesh_shape=[n + 1], **kw)
    except ValueError:
        raised = True
    check(raised, f"mesh_shape=[{n + 1}] on {n} device(s) did not raise ValueError")
    print(json.dumps({"sharded_serve": "yolov13n-JDE", "mesh_1_equal": True,
                      f"mesh_{n + 1}_raises": True}))


def phase_int8_ddp(card: str) -> tuple:
    """Phase 20: the int8 kernel's build, its shapes and int8 serving; data-parallel training;
    sharded serving. Returns (the int8 kernel's per-forward numbers, the launches by path)."""
    import torch

    from sar_yolo_tpu_torch.ops.cuda.flash_attention import reset_launches
    laps, t = {}, time.perf_counter()
    phase_int8_build()
    serve = {name: phase_int8_serve(name, req, batches, card) for name, req, batches in INT8_SERVE}
    laps["int8"], t = time.perf_counter() - t, time.perf_counter()
    reset_launches()
    paths = phase_ddp(card)
    laps["ddp"], t = time.perf_counter() - t, time.perf_counter()
    phase_sharded_serve()
    laps["sharded_serve"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    per_forward = {}
    for name, _, _ in INT8_SERVE:
        rows = serve[name]["rows"]
        pf = per_forward[name.removesuffix(".yaml")] = {k: sum(r[k] for r in rows) for k in (
            "kernel_ms", "plain_ms", "int_mm_ms", "int_mm_with_unfold_ms", "cudnn_bf16_ms",
            "bound_ms", "quantize_ms", "quantize_plain_ms", "quantize_bound_ms")}
        pf["bound_by"] = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
        pf["max_rel_err"] = max(r["epilogue_rel_err"]["float32"] for r in rows)
        pf["max_abs_err"] = max(r["epilogue_abs_err"] for r in rows)
        pf["quantize_xq_abs_err"] = max(r["quantize_xq_abs_err"] for r in rows)
        pf["quantize_sx_abs_err"] = max(r["quantize_sx_abs_err"] for r in rows)
    print(json.dumps({"phase_int8_ddp_s": laps, "int8_per_forward": per_forward}))
    for name, req, batches in INT8_SERVE:
        for b, (_, _, n_attn) in serve[name]["launches"].items():
            paths[f"serve int8={req} {name.removesuffix('.yaml')}@{INT8_IMGSZ} b{b} "
                  "(area attention)"] = n_attn
    conv_launches, quantize_launches, _ = serve["yolov13n-JDE.yaml"]["launches"][INT8_BATCH]
    return per_forward["yolov13n-JDE"], (conv_launches, quantize_launches), paths


EXPORT_IMGSZ = 640        # the served artifacts' input side
EXPORT_BATCH = 8          # letterboxed frames of the artifact gates and of the dynamic batch
EXPORT_CANDIDATES = 200   # the class biases are shifted so that no frame has this many
                          # anchors over the artifacts' threshold (0.25)
EXPORT_MARGIN = 5e-3      # the round trip's conf tolerance (the JAX tests' `_roundtrip`)
ONNX_IMGSZ = 256          # the ONNX artifact's side (the numpy runtime: ~35 s a frame at 640)


def _letterboxed(frames, imgsz: int) -> np.ndarray:
    """BGR frames -> (B, imgsz, imgsz, 3) uint8 RGB, the host letterbox of `BackendPredictor`."""
    from sar_yolo_tpu_torch.data.augment import letterbox
    return np.stack([np.ascontiguousarray(letterbox(f, imgsz, scaleup=False)[0][..., ::-1])
                     for f in frames])


def _eager_program(yolo, u8, with_nms: bool):
    """The eager served model on a letterboxed uint8 RGB batch: the BN-folded forward, then
    `decode_nms` of the predictor at the artifacts' threshold (0.25), or the raw decoded
    predictions with the embeddings inline (the JAX exporter's raw graph)."""
    import torch

    from sar_yolo_tpu_torch.engine.exporter import EXPORT_CONF
    from sar_yolo_tpu_torch.ops.decode import decode_detect
    predictor = yolo._get_predictor({"imgsz": u8.shape[1], "conf": EXPORT_CONF})
    x = torch.from_numpy(u8).to(yolo.device).permute(0, 3, 1, 2).contiguous().float() / 255.0
    with torch.no_grad():
        feats = predictor.model(x)
        if with_nms:
            return predictor.decode_nms(feats)
        meta = yolo.meta
        return decode_detect(feats, meta["strides"], meta["nc"], meta["reg_max"],
                             extra_sigmoid=meta.get("state_classes") or 0)


def _shift_class_bias(yolo, u8, conf: float, n: int, margin: float = 1e-3) -> float:
    """Shift the head's class-logit biases by one constant so that on the batch u8 no frame
    has n anchors whose best score passes `conf` and no best logit lies within `margin` of
    the threshold (`_ab_conf` on the logits). The artifacts' NMS threshold is fixed at 0.25;
    this puts a few hundred candidates a frame over it. Returns the shift."""
    import torch
    preds = _eager_program(yolo, u8, False)
    nc = yolo.meta["nc"]
    best = preds[..., 4:4 + nc].amax(-1).double().clamp(1e-12, 1 - 1e-12)
    level, _ = _ab_conf(torch.logit(best).cpu().numpy(), n, margin)
    shift = float(np.log(conf / (1 - conf)) - level)
    head = yolo.model.blocks[yolo.meta["head_index"]]
    with torch.no_grad():
        for name, p in head.named_parameters():
            if name.startswith("cv3_") and name.endswith("_pred.bias"):
                p.add_(shift)
    yolo._fused = yolo._half = yolo._predictor_cache = None
    return shift


def _program_ops(backend) -> dict:
    """Nodes of the artifact's program: the area-attention op's and einsum's."""
    import torch
    targets = [n.target for n in backend.module.graph.nodes if n.op == "call_function"]
    return {"flash_area_attention": targets.count(
        torch.ops.sar_yolo_tpu_torch.flash_area_attention.default),
            "einsum": targets.count(torch.ops.aten.einsum.default)}


def _profiled(fn, n: int = 5) -> dict:
    """torch.profiler over n calls of fn: the area-attention kernel's launches and device ms,
    and the count of each CPU op, a call."""
    from torch.autograd import DeviceType

    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    events, traces = _complete_trace(lambda: [fn() for _ in range(n)],
                                     ("flash_area_attention_kernel",),
                                     lambda: flash_area_attention.launches)
    kernel = [ev for ev in events if ev.device_type == DeviceType.CUDA
              and "flash_area_attention_kernel" in ev.key]
    cpu = {ev.key: ev.count / n for ev in events if ev.device_type == DeviceType.CPU}
    return {"kernel_launches": sum(ev.count for ev in kernel) / n,
            "kernel_ms": sum(getattr(ev, "device_time_total", 0.0) for ev in kernel) / n / 1e3,
            "einsum": cpu.get("aten::einsum", 0.0),
            "flash_area_attention_op": cpu.get("sar_yolo_tpu_torch::flash_area_attention", 0.0),
            "profiler_traces": traces}


def _rates_in_turns(fns: dict, rounds: int = 2, n: int = 5) -> dict:
    """img/s of each fn (one call serves `batch` images; host clock, synchronized), taken in
    turns, a, b, ..., b, a per round; the median of each fn's runs."""
    import torch
    runs = {k: [] for k in fns}
    for r in range(rounds):
        for key in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            fn, batch = fns[key]
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            runs[key].append(n * batch / (time.perf_counter() - t0))
    return {k: {"img_per_s": statistics.median(v), "runs": v} for k, v in runs.items()}


def _roundtrip_errors(got: list, want: list, label: str, hold: bool = True) -> dict:
    """`YOLO(artifact).predict` against `YOLO.predict`, frame by frame, as the JAX package's
    export tests hold a round trip: the same count, and sorted by conf, boxes within 1.5 px,
    conf within 5e-3 and the classes equal (`hold=False`: measured, not held). Returns the
    kept counts of both and the largest errors over the frames whose counts agree."""
    kept, kept_artifact, box, score, classes = [], [], 0.0, 0.0, True
    for g, w in zip(got, want):
        a, b = (np.asarray(r.boxes.data)[:, :6] for r in (w, g))
        kept.append(len(a))
        kept_artifact.append(len(b))
        if len(a) != len(b) or not len(a):
            continue
        a, b = a[np.argsort(-a[:, 4], kind="stable")], b[np.argsort(-b[:, 4], kind="stable")]
        box = max(box, float(np.abs(a[:, :4] - b[:, :4]).max()))
        score = max(score, float(np.abs(a[:, 4] - b[:, 4]).max()))
        classes &= bool(np.array_equal(a[:, 5], b[:, 5]))
    out = {"kept_per_frame": kept, "kept_per_frame_artifact": kept_artifact,
           "box_err_px": box, "score_err": score, "classes_equal": classes}
    if hold:
        check(len(got) == len(want) and kept == kept_artifact and box <= 1.5 and
              score <= EXPORT_MARGIN and classes, f"{label}: {out}")
    return out


def _fit(img: np.ndarray, imgsz: int) -> np.ndarray:
    """img resized on the host to the size its letterbox gives it (the host letterbox's own
    resize), so that any letterbox of the result only pads."""
    from sar_yolo_tpu_torch.data import cv
    h, w = img.shape[:2]
    r = min(imgsz / h, imgsz / w, 1.0)
    return cv.resize(img, (round(w * r), round(h * r)))


def _export_pair(yolo, root: Path, label: str, card: str) -> tuple:
    """yolo exported as pt2 with embedded NMS (dynamic batch) and raw, each loaded with
    `YOLO(path)` on the card. Returns (the NMS artifact, the raw artifact, their numbers)."""
    from sar_yolo_tpu_torch import YOLO
    out, loaded = {}, []
    for kind, kw in (("nms", dict(nms=True, dynamic=True)), ("raw", dict(nms=False))):
        t0 = time.perf_counter()
        path = yolo.export(format="pt2", imgsz=EXPORT_IMGSZ, project=str(root / kind), **kw)
        t1 = time.perf_counter()
        artifact = YOLO(path)
        out[kind] = {"export_s": t1 - t0, "load_s": time.perf_counter() - t1,
                     "bytes": Path(path).stat().st_size, "path": path}
        check(artifact.backend.device.type == yolo.device.type, f"{label} {kind}: served on "
              f"{artifact.backend.device}, the model is on {yolo.device}")
        loaded.append(artifact)
    print(json.dumps({"export": label, "imgsz": EXPORT_IMGSZ, **out, "card": card}))
    return loaded[0], loaded[1], out


def _artifact_gates(yolo, nms, raw, u8, label: str, launches: int) -> dict:
    """The artifacts against the eager served model on the letterboxed batch u8: the NMS
    artifact's rows at batch 1 and len(u8) (phase 4's gates: the same rows, scores and
    embeddings within 1e-3, boxes within 1e-3 px), the raw artifact's predictions (batch 1)
    within 1e-3, and `launches` area-attention launches a forward of each. `launches` of the
    result: the counter read after each of those forwards, set to 0 just before it."""
    import torch

    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    n_emb = yolo.meta.get("embed_dim") or 0
    out, counts = {}, {}
    for b in (1, len(u8)):
        want = _eager_program(yolo, u8[:b], True).cpu().numpy()
        flash_area_attention.launches = 0
        got = nms.backend(u8[:b]).cpu().numpy()
        counts[f"nms_b{b}"] = flash_area_attention.launches
        check(counts[f"nms_b{b}"] == launches, f"{label} nms b{b}: "
              f"{counts[f'nms_b{b}']} kernel launches a forward, expected {launches}")
        kept, errs = _compare_detections(got, want, n_emb, f"{label} nms b{b}")
        check(errs["box_err_px"] <= 1e-3 and errs["score_err"] <= 1e-3 and
              errs["embed_err"] <= 1e-3, f"{label} nms b{b}: {errs}")
        out[f"nms_b{b}"] = {"kept_per_frame": kept, **errs}
    want = _eager_program(yolo, u8[:1], False)
    flash_area_attention.launches = 0
    got = raw.backend(u8[:1])  # a static program: batch 1
    counts["raw_b1"] = flash_area_attention.launches
    check(counts["raw_b1"] == launches, f"{label} raw: "
          f"{counts['raw_b1']} kernel launches a forward, expected {launches}")
    out["raw_preds_max_abs_err"] = (got - want).abs().max().item()
    check(got.shape == want.shape and out["raw_preds_max_abs_err"] <= 1e-3,
          f"{label} raw: {tuple(got.shape)} vs {tuple(want.shape)}, "
          f"{out['raw_preds_max_abs_err']} off the eager predictions")
    out["launches"] = counts
    return out


def _artifact_rates(yolo, nms, frames, u8) -> dict:
    """img/s at batch 1 and len(u8) in turns: the NMS artifact on the letterboxed uint8
    batch (host to card, forward, NMS, rows to the host), the eager served model on the same
    batch (`_eager_program`), and eager `predict_batched` of the raw frames (its letterbox on
    the card)."""
    from sar_yolo_tpu_torch.engine.exporter import EXPORT_CONF
    out = {}
    for b in (1, len(u8)):
        rates = _rates_in_turns({
            "artifact": (lambda: nms.backend(u8[:b]).cpu(), b),
            "eager_same_input": (lambda: _eager_program(yolo, u8[:b], True).cpu(), b),
            "eager_predict_batched": (lambda: yolo.predict_batched(
                frames[:b], imgsz=EXPORT_IMGSZ, conf=EXPORT_CONF), b)})
        out[f"b{b}"] = rates
    return out


def phase_export(card: str, seed: int = 0) -> dict:
    """Phase 21: export and artifact serving (see the module docstring). Returns the area
    attention's launches by path and its device ms a forward inside the program."""
    import torch

    from sar_yolo_tpu_torch import YOLO
    from sar_yolo_tpu_torch.data.imageio import imread
    from sar_yolo_tpu_torch.export.onnx_runtime import OnnxReferenceRuntime
    from sar_yolo_tpu_torch.nn.modules.block import AAttn
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    root = Path("runs/chip_smoke_export")
    shutil.rmtree(root, ignore_errors=True)
    laps, t = {}, time.perf_counter()
    paths, result = {}, {}

    # yolov13n-JDE @640 (8 ragged 720x1280 frames, host letterbox)
    yolo = _perturbed_yolo("yolov13n-JDE.yaml", seed, EXPORT_IMGSZ)
    frames = np.random.default_rng(seed).integers(0, 256, (EXPORT_BATCH, 720, 1280, 3), np.uint8)
    u8 = _letterboxed(frames, EXPORT_IMGSZ)
    shift = _shift_class_bias(yolo, u8, 0.25, EXPORT_CANDIDATES)
    nms, raw, made = _export_pair(yolo, root / "v13", "yolov13n-JDE", card)
    laps["v13_export"], t = time.perf_counter() - t, time.perf_counter()
    ops = _program_ops(nms.backend)
    n_attn = sum(isinstance(m, AAttn) for m in yolo.model.modules())
    check(ops["flash_area_attention"] == n_attn == 8,
          f"the exported program holds {ops['flash_area_attention']} area-attention nodes, the "
          f"model {n_attn} AAttn")
    gates = _artifact_gates(yolo, nms, raw, u8, "yolov13n-JDE", LAUNCHES_PER_FORWARD)
    prof = _profiled(lambda: nms.backend(u8))
    eager_prof = _profiled(lambda: _eager_program(yolo, u8, True))
    check(prof["kernel_launches"] == LAUNCHES_PER_FORWARD and
          prof["flash_area_attention_op"] == n_attn and
          prof["einsum"] == ops["einsum"],
          f"profiler over the artifact's forward: {prof}; its program's einsum nodes "
          f"{ops['einsum']} (none of them attention)")
    rates = _artifact_rates(yolo, nms, frames, u8)
    result["v13"] = {"export": "yolov13n-JDE", "class_bias_shift": shift, "program_ops": ops,
                     **gates, f"profiler_artifact_b{EXPORT_BATCH}": prof,
                     f"profiler_eager_b{EXPORT_BATCH}": eager_prof,
                     "rates": rates, "card": card}
    print(json.dumps(result["v13"]))
    paths[f"pt2 artifact yolov13n-JDE@{EXPORT_IMGSZ} (nms b1 + b{EXPORT_BATCH}, raw b1: one "
          "forward each)"] = sum(gates["launches"].values())
    laps["v13_gates"], t = time.perf_counter() - t, time.perf_counter()

    # YOLO(path).predict of the JPEG frames against YOLO.predict. As files, the artifact's
    # host letterbox rounds the resized frames to uint8 where the card's keeps float32:
    # measured, not held (a random-weight model moves scores by ~1e-2 and boxes by pixels
    # under that half-grey-level difference). Held: the frames resized on the host first, so
    # that both letterboxes only pad and the two paths see the same input.
    jpegs = [imread(f) for f in sorted((JPEG_DIR / "frames").glob("*.jpg"))]
    fitted = [_fit(f, EXPORT_IMGSZ) for f in jpegs]
    predictor = yolo._get_predictor({"imgsz": EXPORT_IMGSZ})
    with torch.no_grad():
        scores = torch.cat([predictor.decode(predictor.model(predictor.preprocess(f[None])[0]))[0]
                            [..., 4:4 + yolo.meta["nc"]].flatten(1) for f in fitted])
    conf, gap = _ab_conf(scores.double().cpu().numpy(), 300, margin=EXPORT_MARGIN)
    flash_area_attention.launches = 0
    got = raw.predict(str(JPEG_DIR / "frames"), conf=conf)
    check(flash_area_attention.launches == JPEG_FRAMES * LAUNCHES_PER_FORWARD,
          f"YOLO(artifact).predict: {flash_area_attention.launches} launches")
    paths[f"YOLO(pt2 artifact).predict {JPEG_FRAMES} JPEG frames"] = flash_area_attention.launches
    files = _roundtrip_errors(got, yolo.predict(str(JPEG_DIR / "frames"), imgsz=EXPORT_IMGSZ,
                                                conf=conf), "files", hold=False)
    held = _roundtrip_errors(raw.predict(fitted, conf=conf),
                             yolo.predict(fitted, imgsz=EXPORT_IMGSZ, conf=conf),
                             "YOLO(artifact).predict of the fitted JPEG frames")
    result["predict"] = {"yolo_artifact_predict_jpeg": f"{JPEG_FRAMES} frames", "conf": conf,
                         "conf_half_gap": gap, "jpeg_files_not_held": files,
                         "jpeg_fitted_held": held,
                         "speed_ms_median": {k: statistics.median(r.speed[k] for r in got)
                                             for k in ("preprocess", "inference", "postprocess")},
                         "card": card}
    print(json.dumps(result["predict"]))
    laps["predict"], t = time.perf_counter() - t, time.perf_counter()

    # ONNX: raw, one frame through the port's numpy runtime on the host
    t0 = time.perf_counter()
    onnx_path = yolo.export(format="onnx", imgsz=ONNX_IMGSZ, project=str(root / "onnx"))
    t1 = time.perf_counter()
    one = u8[:1] if ONNX_IMGSZ == EXPORT_IMGSZ else _letterboxed(frames[:1], ONNX_IMGSZ)
    host = OnnxReferenceRuntime(onnx_path)(one)[0]
    t2 = time.perf_counter()
    ref = _eager_program(yolo, one, False).cpu().numpy()
    err = np.abs(host - ref) - 1e-3 * np.abs(ref)
    result["onnx"] = {"onnx": "yolov13n-JDE raw", "imgsz": ONNX_IMGSZ, "export_s": t1 - t0,
                      "bytes": Path(onnx_path).stat().st_size, "numpy_runtime_s": t2 - t1,
                      "max_abs_err": float(np.abs(host - ref).max()),
                      "max_err_over_rtol": float(err.max()), "card": card}
    print(json.dumps(result["onnx"]))
    check(host.shape == ref.shape and err.max() <= 2e-3,
          f"ONNX numpy runtime vs the eager predictions: {result['onnx']}")
    laps["onnx"], t = time.perf_counter() - t, time.perf_counter()

    # yolov8n (bench.py's config): no area attention
    v8 = _perturbed_yolo("yolov8n.yaml", seed + 1, EXPORT_IMGSZ)
    frames8 = np.random.default_rng(seed + 1).integers(0, 256, (EXPORT_BATCH, *BENCH_HW, 3),
                                                       np.uint8)
    u8_8 = _letterboxed(frames8, EXPORT_IMGSZ)
    shift8 = _shift_class_bias(v8, u8_8, 0.25, EXPORT_CANDIDATES)
    nms8, raw8, _ = _export_pair(v8, root / "v8", "yolov8n", card)
    result["v8"] = {"export": "yolov8n", "class_bias_shift": shift8,
                    **_artifact_gates(v8, nms8, raw8, u8_8, "yolov8n", 0),
                    "rates": _artifact_rates(v8, nms8, frames8, u8_8), "card": card}
    print(json.dumps(result["v8"]))
    laps["v8"] = time.perf_counter() - t
    print(json.dumps({"phase_export_s": laps}))
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"paths": paths, "kernel_ms_per_forward": prof["kernel_ms"],
            "eager_kernel_ms_per_forward": eager_prof["kernel_ms"],
            "launches_per_forward": gates["launches"][f"nms_b{EXPORT_BATCH}"],
            "profiler_launches_per_forward": prof["kernel_launches"]}


SAM_SERVE = (("sam_b", 1024), ("mobile_sam", 1024))  # full width, Meta's serving size
SAM_GRID = (32, 64)       # generate's points_per_side and points_per_batch (Meta's AMG default)
SAM_MIN_CANDIDATES = 20   # candidates generate's thresholds must pass
SAM_MASK_LOGIT = 20.0     # the hypernetworks' last layers scaled to this largest |mask logit|
SAM_IOU_TOL = 1e-4        # IoU predictions against float64
# image embeddings against float64 (max abs over LayerNorm'd values up to ~4.3): 10x the
# largest float32 distance measured (1.07e-5 for sam_b, 1.00e-5 for mobile_sam, NVIDIA H100,
# PERF.md section 6); mask pixels whose float64 logit (of +-20) is within 10x the largest
# measured logit distance (2.96e-5) of 0 are left out of the mask comparison
SAM_EMB_TOL = 1e-4
SAM_LOGIT_TOL = 3e-4
FASTSAM_IMGSZ = 640       # FastSAM-s and yolo_nas serving size


def _sam_vs_f64(p32, p64, prompts: dict, slots, label: str, logit_tol: float = SAM_LOGIT_TOL
                ) -> dict:
    """One prompt batch decoded by the float32 and the float64 predictor: IoU predictions of
    all four slots within SAM_IOU_TOL, and the masks of `slots` at the original size equal
    wherever the float64 logit is farther than `logit_tol` from 0."""
    arrays = p32._prompt_arrays(**prompts)
    low32, iou32 = p32.decode(*arrays)
    low64, iou64 = p64.decode(*arrays)
    iou_err = (iou32.double() - iou64).abs().max().item()
    logit_err, excluded, differ = 0.0, 0, 0
    for s in slots:
        l32, l64 = p32.to_original(low32[:, s]), p64.to_original(low64[:, s])
        logit_err = max(logit_err, (l32.double() - l64).abs().max().item())
        decided = l64.abs() > logit_tol
        excluded += int((~decided).sum())
        differ += int(((l32 > 0) != (l64 > 0))[decided].sum())
    out = {"queries": int(iou32.shape[0]), "iou_max_abs_err": iou_err,
           "logit_max_abs_err": logit_err, "pixels_within_logit_tol": excluded,
           "pixels": int(iou32.shape[0]) * len(slots) * int(np.prod(p32._im_meta[:2]))}
    check(iou_err <= SAM_IOU_TOL, f"{label}: IoU predictions {iou_err:.3g} from float64")
    check(differ == 0, f"{label}: {differ} mask pixels differ from float64 where its logit "
          f"is over {logit_tol} from 0")
    return out


def _sam_generate_vs_f64(p32, p64, label: str) -> dict:
    """Segment-everything's device scoring in float32 and float64, thresholds in gaps of the
    float64 scores that at least SAM_MIN_CANDIDATES candidates pass, and the survivors of the
    filters and greedy NMS: the same set unless a near-tie decides (a candidate's IoU within
    SAM_IOU_TOL of the threshold or of another's, or its stability or box moved by a
    low-resolution logit that float32 rounds across +-1 or 0)."""
    pps, ppb = SAM_GRID
    _, iou32, stab32, box32 = p32.score_grid(pps, ppb)
    _, iou64, stab64, box64 = p64.score_grid(pps, ppb)
    iou_err = float(np.abs(iou32.astype(np.float64) - iou64).max())
    check(iou_err <= SAM_IOU_TOL, f"{label}: grid IoU predictions {iou_err:.3g} from float64")
    valid = (box64[:, 2] > box64[:, 0]) & (box64[:, 3] > box64[:, 1])
    check(valid.sum() >= SAM_MIN_CANDIDATES, f"{label}: {valid.sum()} non-empty candidates")
    # about 8x, then 3x SAM_MIN_CANDIDATES pass the stability, then the IoU threshold
    stab_thr = _gap_threshold(stab64[valid], max(0.5, 1 - 8 * SAM_MIN_CANDIDATES / valid.sum()),
                              1e-4)
    stable = valid & (stab64 > stab_thr)
    conf = _gap_threshold(iou64[stable], max(0.25, 1 - 3 * SAM_MIN_CANDIDATES / stable.sum()),
                          SAM_IOU_TOL)
    passing = valid & (stab64 > stab_thr) & (iou64 > conf)
    check(passing.sum() >= SAM_MIN_CANDIDATES,
          f"{label}: {passing.sum()} candidates pass conf {conf} and stability {stab_thr}")
    sel32 = p32.select(iou32, stab32, box32, conf, stab_thr, 300)
    sel64 = p64.select(iou64, stab64, box64, conf, stab_thr, 300)
    moved = (stab32 != stab64) | (box32 != box64).any(1)
    out = {"candidates": int(len(iou32)), "non_empty": int(valid.sum()), "conf": conf,
           "stability_thresh": stab_thr, "passing": int(passing.sum()),
           "survivors": int(len(sel64)), "same_survivors": set(sel32) == set(sel64),
           "iou_max_abs_err": iou_err, "stability_moved": int((stab32 != stab64).sum()),
           "boxes_moved": int((box32 != box64).any(1).sum())}
    if not out["same_survivors"]:
        either = np.union1d(np.flatnonzero(passing | moved), np.concatenate([sel32, sel64]))
        near = np.abs(iou64[either] - conf) <= SAM_IOU_TOL
        s = np.sort(iou64[passing])
        ties = bool((np.diff(s) <= SAM_IOU_TOL).any())
        out["near_ties"] = int(near.sum() + moved[either].sum()) + int(ties)
        check(out["near_ties"] > 0, f"{label}: survivors differ from float64 without a near-tie "
              f"({sorted(set(sel32) ^ set(sel64))[:8]})")
    return out


def _sam_serve(name: str, imgsz: int, frame: np.ndarray, persons: list, card: str) -> dict:
    """One full-width SAM model on the card: build, the float64 copy, set_image, box / point /
    multimask prompts and generate, each held against float64; times and peak memory."""
    import torch

    from sar_yolo_tpu_torch import SAM
    from sar_yolo_tpu_torch.models.sam.predict import SAMPredictor
    t0 = time.perf_counter()
    sam = SAM(name, imgsz=imgsz)
    check(sam.device.type == "cuda", f"{name} built on {sam.device}")
    p32 = sam.predictor
    torch.cuda.synchronize()
    out = {"model": name, "imgsz": imgsz, "build_s": time.perf_counter() - t0,
           "params": sam.info()["params"], "card": card}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    p32.set_image(frame)
    torch.cuda.synchronize()
    out["encode_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    enc = sam.model.image_encoder
    if hasattr(enc, "depth"):  # the ViT: a global block's float32 logits, (1, heads, N, N)
        n_tok = (imgsz // 16) ** 2
        out["global_logits_mib"] = enc.block_0.attn.num_heads * n_tok ** 2 * 4 / 2 ** 20
    out["mask_gain"] = _sam_mask_gain(sam)
    m64 = copy.deepcopy(sam.model).double()
    p64 = SAMPredictor(m64, imgsz=imgsz)
    p64.set_image(frame)
    emb_err = (p32._features.double() - p64._features).abs().max().item()
    out["embedding_max_abs_err"] = emb_err
    out["embedding_max_abs"] = p64._features.abs().max().item()
    check(emb_err <= SAM_EMB_TOL, f"{name}: embedding {emb_err:.3g} from float64")
    x = torch.from_numpy(np.zeros((1, imgsz, imgsz, 3), np.uint8)).cuda()
    with torch.no_grad():
        out["encode_ms"] = event_ms(lambda: sam.model.encode(x), iters=5, reps=3)
    boxes = [p[1:5] for p in persons]
    cx, cy = [(b[0] + b[2]) / 2 for b in boxes], [(b[1] + b[3]) / 2 for b in boxes]
    prompts = {
        "boxes": (dict(bboxes=boxes, points=None, labels=None), (0,)),
        "points_one_negative": (dict(bboxes=None, points=[[[cx[0], cy[0]], [cx[1], cy[1]]]],
                                     labels=[[1, 0]]), (0,)),
        "multimask": (dict(bboxes=None, points=[[x, y] for x, y in zip(cx[:3], cy[:3])],
                           labels=None), (1, 2, 3))}
    out["prompts"] = {k: _sam_vs_f64(p32, p64, kw, slots, f"{name} {k}")
                      for k, (kw, slots) in prompts.items()}
    masks, scores = p32.prompt_inference(bboxes=boxes)
    check(masks.shape == (len(boxes), *frame.shape[:2]) and np.isfinite(scores).all(),
          f"{name}: prompt_inference gave {masks.shape}")
    masks, scores = p32.prompt_inference(points=prompts["multimask"][0]["points"],
                                         multimask_output=True)
    check(masks.shape == (3, *frame.shape[:2]), f"{name}: multimask gave {masks.shape}")
    arrays = p32._prompt_arrays(boxes, None, None)
    out["decode_ms"] = event_ms(lambda: p32.decode(*arrays), iters=10, reps=3)
    out["decode_queries"] = len(boxes)
    out["generate"] = _sam_generate_vs_f64(p32, p64, name)
    del m64, p64
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(points_per_side=SAM_GRID[0], points_per_batch=SAM_GRID[1],
              conf=out["generate"]["conf"], stability_thresh=out["generate"]["stability_thresh"])
    p32.generate(**kw)  # warm
    t = time.perf_counter()
    masks, scores, gboxes = p32.generate(**kw)
    out["generate_ms"] = (time.perf_counter() - t) * 1e3
    out["generate_split_ms"] = dict(p32.generate_ms)
    out["generate_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    check(len(masks) == out["generate"]["survivors"] or not out["generate"]["same_survivors"],
          f"{name}: generate kept {len(masks)}, select {out['generate']['survivors']}")
    check(masks.shape[1:] == frame.shape[:2] and np.isfinite(gboxes).all(),
          f"{name}: generate gave {masks.shape}")
    res = sam(frame, bboxes=boxes[:2])[0]
    check(res.masks.data.shape == (2, *frame.shape[:2]) and res.boxes.data.shape == (2, 6),
          f"{name}: SAM.__call__ gave {res.masks.data.shape}")
    out["call_speed_ms"] = res.speed
    print(json.dumps(out))
    del sam
    torch.cuda.empty_cache()
    return out


def _fastsam_nas(frames: list, persons: list) -> dict:
    """FastSAM-s @640 with a box prompt and yolo_nas @640 at batch 1 over the JPEG frames
    (seeded, perturbed weights), against the plain YOLO segment and detect path on the same
    weights: FastSAM's Results equal the plain Results filtered by `FastSAM._prompt`; NAS's
    rows equal the plain ones."""
    import torch

    from sar_yolo_tpu_torch import NAS, YOLO, FastSAM
    out = {}
    kw = dict(imgsz=FASTSAM_IMGSZ, conf=0.05)
    fast = _perturbed_yolo("FastSAM-s.yaml", 3, FASTSAM_IMGSZ, cls=FastSAM)
    plain = YOLO("FastSAM-s.yaml")
    plain.model.load_state_dict(fast.model.state_dict())
    plain._weights_ready = True
    check(fast.task == "segment" and fast.meta["nc"] == 1, "FastSAM-s is not a 1-class segmenter")
    t = time.perf_counter()
    kept, rows = [], 0
    for frame, ps in zip(frames, persons):
        box = [ps[0][1:5]]
        got = fast.predict(frame, bboxes=box, **kw)[0]
        want = plain.predict(frame, **kw)[0]
        rows += len(want.boxes)
        want = FastSAM._prompt(want, box, None, None, None, None)
        check(np.array_equal(got.boxes.data, want.boxes.data) and
              np.array_equal(got.masks.data, want.masks.data),
              "FastSAM's box-prompted Results differ from the plain segment path's")
        kept.append(len(got.boxes))
    out["fastsam"] = {"frames": len(frames), "kept_by_prompt": kept, "rows_before_prompt": rows,
                      "s": time.perf_counter() - t}
    check(sum(kept) >= 1, "FastSAM's box prompt kept no mask on any frame")
    nas = _perturbed_yolo("yolo_nas.yaml", 4, FASTSAM_IMGSZ, cls=NAS)
    plain = YOLO("yolo_nas.yaml")
    plain.model.load_state_dict(nas.model.state_dict())
    plain._weights_ready = True
    t = time.perf_counter()
    got = nas.predict(frames, **kw)
    want = plain.predict(frames, **kw)
    check(all(np.array_equal(g.boxes.data, w.boxes.data) for g, w in zip(got, want)),
          "NAS rows differ from the plain detect path's")
    out["nas"] = {"frames": len(frames), "rows": [len(g.boxes) for g in got],
                  "s": time.perf_counter() - t}
    raised = False
    try:
        nas.train(data="synthetic")
    except NotImplementedError:
        raised = True
    check(raised, "NAS.train did not raise")
    print(json.dumps(out))
    del fast, plain, nas
    torch.cuda.empty_cache()
    return out


def phase_sam(card: str) -> dict:
    """Phase 22: SAM and MobileSAM at full width on one 720x1280 JPEG frame, FastSAM and NAS
    (see the module docstring). Returns the area attention's launches by path (0: no model of
    this phase has an A2C2f block)."""
    from sar_yolo_tpu_torch.data.imageio import imread
    from sar_yolo_tpu_torch.ops.cuda import int8_conv as ic
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    digests = json.loads((JPEG_DIR / "digests.json").read_text())["frames"]
    names = sorted(digests)
    frames = [imread(JPEG_DIR / "frames" / n) for n in names]
    persons = [digests[n]["persons"] for n in names]
    laps, t = {}, time.perf_counter()
    paths = {}
    for name, imgsz in SAM_SERVE:
        flash_area_attention.launches = 0
        _sam_serve(name, imgsz, frames[0], persons[0], card)
        paths[f"SAM {name}@{imgsz}: set_image, prompts, generate (float32)"] = \
            flash_area_attention.launches
        laps[name], t = time.perf_counter() - t, time.perf_counter()
    flash_area_attention.launches = 0
    ic.reset_launches()
    _fastsam_nas(frames, persons)
    laps["fastsam_nas"] = time.perf_counter() - t
    paths[f"FastSAM-s@{FASTSAM_IMGSZ} and yolo_nas@{FASTSAM_IMGSZ} b1, {len(frames)} JPEG "
          "frames"] = flash_area_attention.launches
    print(json.dumps({"phase_sam_s": laps, "area_attention_launches": paths,
                      "int8_launches": [ic.int8_conv.launches, ic.int8_quantize.launches]}))
    check(not any(paths.values()), f"area-attention launches in phase 22: {paths}")
    return paths


SAM2_SERVE = ("sam2_b", 1024)   # Hiera-B+ at full width, Meta's serving size
SAM2_SIZES = ("sam2_t", "sam2_s", "sam2_l")  # built at 1024, one box prompt each
SAM2_TRACK_FRAMES = 12    # the JPEG frames SAM.track carries the 6 persons through
# against the float64 copy (max abs), 10x the largest float32 distance of the first run
# (NVIDIA H100, PERF.md section 6): the stride-16 embeddings and high-resolution maps
# (7.06e-6); the track step's conditioned embedding (8.57e-6), object logits (8.72e-8) and
# new memory entry (1.32e-5; the prompted frame's 8.77e-6); mask pixels whose float64 logit
# is within 10x the largest logit distance (1.50e-5) of 0 are left out of the mask comparisons
SAM2_EMB_TOL = 7.1e-5
SAM2_LOGIT_TOL = 1.5e-4
SAM2_COND_TOL = 8.6e-5
SAM2_OBJ_TOL = 8.8e-7
SAM2_MEM_TOL = 1.4e-4


def _max_err(a, b) -> float:
    return (a.double() - b).abs().max().item()


def _ring_expected(k: int, T: int) -> tuple:
    """(tpos, slot) of track step k: slot 0 holds the prompted frame (0 back); step j wrote
    slot 1 + j % (T - 1); a slot last written at step j is min(max(k - j + 1, 1), T - 1)
    back, an empty one T - 1."""
    written = {}
    for j in range(k):
        written[1 + j % (T - 1)] = j
    tpos = [0] + [min(max(k - written[s] + 1, 1), T - 1) if s in written else T - 1
                  for s in range(1, T)]
    return np.asarray(tpos), 1 + k % (T - 1)


def _sam2_image(sam, m64, frame: np.ndarray, persons: list) -> dict:
    """SAM2's image path on one frame against the float64 copy: the embeddings, box / point /
    multimask prompts and generate (phase 22's rules); times and peak memory."""
    import torch

    from sar_yolo_tpu_torch.models.sam.predict import SAMPredictor
    p32, imgsz = sam.predictor, sam.info_dict["img_size"]
    p64 = SAMPredictor(m64, imgsz=imgsz)
    out = {}
    p64.set_image(frame)
    f32, f64 = p32._features, p64._features
    errs = {"image_embed": _max_err(f32["image_embed"], f64["image_embed"]),
            "high_res_s4": _max_err(f32["high_res_feats"][0], f64["high_res_feats"][0]),
            "high_res_s8": _max_err(f32["high_res_feats"][1], f64["high_res_feats"][1])}
    out["embedding_max_abs_err"] = errs
    out["embedding_max_abs"] = {"image_embed": f64["image_embed"].abs().max().item(),
                                "high_res_s4": f64["high_res_feats"][0].abs().max().item(),
                                "high_res_s8": f64["high_res_feats"][1].abs().max().item()}
    for key, err in errs.items():
        check(err <= SAM2_EMB_TOL, f"{sam.info_dict['name']}: {key} {err:.3g} from float64")
    boxes = [p[1:5] for p in persons]
    cx, cy = [(b[0] + b[2]) / 2 for b in boxes], [(b[1] + b[3]) / 2 for b in boxes]
    prompts = {
        "boxes": (dict(bboxes=boxes, points=None, labels=None), (0,)),
        "points_one_negative": (dict(bboxes=None, points=[[[cx[0], cy[0]], [cx[1], cy[1]]]],
                                     labels=[[1, 0]]), (0,)),
        "multimask": (dict(bboxes=None, points=[[x, y] for x, y in zip(cx[:3], cy[:3])],
                           labels=None), (1, 2, 3))}
    name = sam.info_dict["name"]
    out["prompts"] = {k: _sam_vs_f64(p32, p64, kw, slots, f"{name} {k}", SAM2_LOGIT_TOL)
                      for k, (kw, slots) in prompts.items()}
    masks, scores = p32.prompt_inference(bboxes=boxes)
    check(masks.shape == (len(boxes), *frame.shape[:2]) and np.isfinite(scores).all(),
          f"{name}: prompt_inference gave {masks.shape}")
    masks, scores = p32.prompt_inference(points=prompts["multimask"][0]["points"],
                                         multimask_output=True)
    check(masks.shape == (3, *frame.shape[:2]), f"{name}: multimask gave {masks.shape}")
    arrays = p32._prompt_arrays(boxes, None, None)
    out["decode_ms"] = event_ms(lambda: p32.decode(*arrays), iters=10, reps=3)
    out["generate"] = _sam_generate_vs_f64(p32, p64, name)
    del p64
    torch.cuda.empty_cache()
    kw = dict(points_per_side=SAM_GRID[0], points_per_batch=SAM_GRID[1],
              conf=out["generate"]["conf"], stability_thresh=out["generate"]["stability_thresh"])
    t = time.perf_counter()
    masks, scores, gboxes = p32.generate(**kw)
    out["generate_ms"] = (time.perf_counter() - t) * 1e3
    out["generate_split_ms"] = dict(p32.generate_ms)
    check(len(masks) == out["generate"]["survivors"] or not out["generate"]["same_survivors"],
          f"{name}: generate kept {len(masks)}, select {out['generate']['survivors']}")
    check(masks.shape[1:] == frame.shape[:2] and np.isfinite(gboxes).all(),
          f"{name}: generate gave {masks.shape}")
    return out


def _sam2_video(sam, m64, frames: list, boxes: list) -> dict:
    """The video predictor over the frames with the persons' boxes on the first: each float32
    step against the float64 model's step on the same bank (cast), the ring's slot and tpos
    against the rule; the float32 trajectory's masks against an all-float64 run (printed,
    not held); the step split and peak memory at the last step's full bank."""
    import torch

    from sar_yolo_tpu_torch.models.sam.predict import SAM2VideoPredictor
    imgsz, T, Q = sam.info_dict["img_size"], sam.model.num_maskmem, len(boxes)
    v32 = SAM2VideoPredictor(sam.model, imgsz=imgsz)
    v64 = SAM2VideoPredictor(m64, imgsz=imgsz)
    step64 = v64._build_step(Q)
    v32.init_video(frames[0], bboxes=boxes)
    v64.init_video(frames[0], bboxes=boxes)
    out = {"objects": Q, "frames": len(frames),
           "init_memory_max_abs_err": _max_err(v32._bank[:, 0], v64._bank[:, 0])}
    check(out["init_memory_max_abs_err"] <= SAM2_MEM_TOL,
          f"the prompted frame's memory {out['init_memory_max_abs_err']:.3g} from float64")
    worst = {"cond": 0.0, "logit": 0.0, "score": 0.0, "obj": 0.0, "new_mem": 0.0}
    excluded, pixels, traj32 = 0, 0, []
    for k, frame in enumerate(frames[1:]):
        tpos, slot = _ring_expected(k, T)
        masks32, _, _ = v32.track_step(frame)
        traj32.append(masks32)
        st = v32.last_step
        check(st["slot"] == slot and np.array_equal(st["tpos"], tpos),
              f"step {k}: slot {st['slot']} tpos {st['tpos']}, the rule gives {slot} {tpos}")
        m64_, s64, o64, mem64, cond64 = step64(st["canvas"], st["bank"].double(),
                                               st["valid"].double(),
                                               torch.as_tensor(tpos, device=st["canvas"].device))
        l32, l64 = v32.to_original(st["low_res"]), v64.to_original(m64_)
        decided = l64.abs() > SAM2_LOGIT_TOL
        differ = int(((l32 > 0) != (l64 > 0))[decided].sum())
        excluded += int((~decided).sum())
        pixels += decided.numel()
        errs = {"cond": _max_err(st["cond"], cond64), "logit": _max_err(l32, l64),
                "score": _max_err(st["score"], s64), "obj": _max_err(st["obj"], o64),
                "new_mem": _max_err(st["new_mem"], mem64)}
        worst = {key: max(worst[key], errs[key]) for key in worst}
        check(differ == 0, f"track step {k}: {differ} mask pixels differ from float64 where its "
              f"logit is over {SAM2_LOGIT_TOL} from 0")
        for key, tol in (("cond", SAM2_COND_TOL), ("score", SAM_IOU_TOL), ("obj", SAM2_OBJ_TOL),
                         ("new_mem", SAM2_MEM_TOL)):
            check(errs[key] <= tol, f"track step {k}: {key} {errs[key]:.3g} from float64")
    out["step_max_abs_err"] = worst
    out["pixels_within_logit_tol"], out["pixels"] = excluded, pixels
    out["ring"] = {"slot_frame": v32._slot_frame.tolist(), "next": v32.ring_state()[1]}
    # the step's split and peak memory on the last step's full bank
    st = v32.last_step
    model, bank, valid = sam.model, v32._bank, v32._valid
    tpos_t = torch.as_tensor(v32.ring_state()[0], device=bank.device)
    with torch.no_grad():
        feats = model.encode(st["canvas"])
        cond = model.condition_on_memory(feats["raw_embed"], bank, valid, tpos_t)
        f = {"image_embed": cond, "high_res_feats": feats["high_res_feats"]}
        pts = torch.zeros(Q, 1, 2, device=bank.device)
        lbl = -torch.ones(Q, 1, device=bank.device)
        m0 = model.decode(f, points=pts, labels=lbl)[0][:, 0]
        out["step_split_ms"] = {
            "encode": event_ms(lambda: model.encode(st["canvas"]), iters=3, reps=3),
            "condition_on_memory": event_ms(lambda: model.condition_on_memory(
                feats["raw_embed"], bank, valid, tpos_t), iters=3, reps=3),
            "decode": event_ms(lambda: model.decode(f, points=pts, labels=lbl), iters=3, reps=3),
            "encode_memory": event_ms(lambda: model.encode_memory(feats["raw_embed"],
                                                                  m0[:, None]), iters=3, reps=3)}
        del feats, cond, f, m0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        v32._step(st["canvas"], bank, valid, tpos_t)
        torch.cuda.synchronize()
    out["step_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    out["cross_attention_logits_mib_per_object_layer"] = (
        (imgsz // 16) ** 4 * T * st["cond"].element_size() / 2 ** 20)
    out["step_ms"] = event_ms(lambda: v32._step(st["canvas"], bank, valid, tpos_t), iters=3,
                              reps=3)
    # the all-float64 trajectory (reported, not held: float32 and float64 part where a logit
    # sits near 0 and the masks then feed the bank)
    v64.init_video(frames[0], bboxes=boxes)
    agree = []
    for frame, masks32 in zip(frames[1:], traj32):
        masks64, _, _ = v64.track_step(frame)
        inter = (masks32 & masks64).sum((1, 2))
        union = np.maximum((masks32 | masks64).sum((1, 2)), 1)
        agree.append({"pixels_equal": float((masks32 == masks64).mean()),
                      "min_iou": float((inter / union).min())})
    out["trajectory_vs_float64"] = agree
    return out


def _sam2_track_call(sam, frames: list, boxes: list) -> dict:
    """`SAM.track` over the frames: one Results a frame with masks, boxes, the id column and
    `frame`; frames/s and the step's peak memory."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = sam.track(frames, bboxes=boxes)
    torch.cuda.synchronize()
    s = time.perf_counter() - t
    n, H, W = len(boxes), *frames[0].shape[:2]
    check(len(res) == len(frames), f"SAM.track gave {len(res)} Results for {len(frames)} frames")
    for i, r in enumerate(res):
        check(r.frame == i and r.masks.data.shape == (n, H, W) and r.boxes.data.shape == (n, 7)
              and r.boxes.data[:, 6].tolist() == list(range(n))
              and np.isfinite(r.boxes.data).all(), f"SAM.track frame {i}: {r.boxes.data[:2]}")
    return {"frames": len(frames), "s": s, "frames_per_s": len(frames) / s,
            "mask_pixels_per_frame": [int(r.masks.data.sum()) for r in res],
            "speed_ms": [r.speed["inference"] for r in res]}


def phase_sam2(card: str) -> dict:
    """Phase 23: SAM2 (see the module docstring). Returns the area attention's launches by
    path (0: SAM2 has no A2C2f block)."""
    import torch

    from sar_yolo_tpu_torch import SAM
    from sar_yolo_tpu_torch.data.imageio import imread
    from sar_yolo_tpu_torch.models.sam.amg import build_point_grid
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    digests = json.loads((JPEG_DIR / "digests.json").read_text())["frames"]
    names = sorted(digests)[:SAM2_TRACK_FRAMES]
    frames = [imread(JPEG_DIR / "frames" / n) for n in names]
    boxes = [p[1:5] for p in digests[names[0]]["persons"]]
    laps, t = {}, time.perf_counter()
    paths = {}
    name, imgsz = SAM2_SERVE
    flash_area_attention.launches = 0
    sam = SAM(name, imgsz=imgsz)
    check(sam.device.type == "cuda", f"{name} built on {sam.device}")
    torch.cuda.synchronize()
    out = {"model": name, "imgsz": imgsz, "card": card, "build_s": time.perf_counter() - t,
           "params": sam.info()["params"]}
    p32 = sam.predictor
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    p32.set_image(frames[0])
    torch.cuda.synchronize()
    out["encode_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    trunk = sam.model.trunk
    g = next(i for i in range(trunk.depth) if getattr(trunk, f"block_{i}").window_size == 0)
    out["global_logits_mib"] = (getattr(trunk, f"block_{g}").attn.num_heads
                                * (imgsz // 16) ** 4 * 4 / 2 ** 20)
    x = torch.zeros((1, imgsz, imgsz, 3), dtype=torch.uint8, device=sam.device)
    with torch.no_grad():
        out["encode_ms"] = event_ms(lambda: sam.model.encode(x), iters=5, reps=3)
    # random weights give mask logits of ~0.1: the hypernetworks' last layers are scaled so
    # that the first grid chunk's largest |logit| is SAM_MASK_LOGIT, as in phase 22
    h, w, nh, nw = p32._im_meta
    pts = build_point_grid(SAM_GRID[0])[:SAM_GRID[1], None] * np.float32([nw, nh])
    low, _ = p32.decode(pts, np.ones((len(pts), 1), np.float32))
    gain = SAM_MASK_LOGIT / low.abs().max().item()
    dec = sam.model.sam_mask_decoder
    with torch.no_grad():
        for i in range(dec.n_tokens):
            getattr(dec, f"hyper_mlp_{i}").l2.weight.mul_(gain)
            getattr(dec, f"hyper_mlp_{i}").l2.bias.mul_(gain)
    out["mask_gain"] = gain
    m64 = copy.deepcopy(sam.model).double()
    out["image"] = _sam2_image(sam, m64, frames[0], digests[names[0]]["persons"])
    laps["image"], t = time.perf_counter() - t, time.perf_counter()
    paths[f"SAM2 {name}@{imgsz}: set_image, prompts, generate (float32)"] = \
        flash_area_attention.launches
    flash_area_attention.launches = 0
    out["video"] = _sam2_video(sam, m64, frames, boxes)
    del m64
    torch.cuda.empty_cache()
    laps["video_vs_float64"], t = time.perf_counter() - t, time.perf_counter()
    flash_area_attention.launches = 0
    sam.track(frames[:2], bboxes=boxes)  # warm
    out["track"] = _sam2_track_call(sam, frames, boxes)
    paths[f"SAM2 {name}@{imgsz}: SAM.track, {len(frames)} JPEG frames, {len(boxes)} objects"] = \
        flash_area_attention.launches
    laps["track"], t = time.perf_counter() - t, time.perf_counter()
    print(json.dumps(out))
    del sam, p32
    torch.cuda.empty_cache()
    sizes = {}
    flash_area_attention.launches = 0
    for size in SAM2_SIZES:
        t0 = time.perf_counter()
        sam = SAM(size, imgsz=imgsz)
        sam.predictor.set_image(frames[0])
        masks, scores = sam.predictor.prompt_inference(bboxes=boxes[:1])
        check(masks.shape == (1, *frames[0].shape[:2]) and np.isfinite(scores).all(),
              f"{size}: a box prompt gave {masks.shape}")
        sizes[size] = {"params": sam.info()["params"], "s": time.perf_counter() - t0}
        del sam
        torch.cuda.empty_cache()
    paths[f"SAM2 {', '.join(SAM2_SIZES)}@{imgsz}: build, one box prompt"] = \
        flash_area_attention.launches
    laps["sizes"] = time.perf_counter() - t
    print(json.dumps({"sam2_sizes": sizes, "phase_sam2_s": laps,
                      "area_attention_launches": paths}))
    check(not any(paths.values()), f"area-attention launches in phase 23: {paths}")
    return paths


VIDEO_DIR = Path("tests/data/video")  # the committed fixture (tools/torch_port_video_fixtures.py)
VIDEO_FRAMES = 24                     # flight.avi: 720x1280 Motion-JPEG at 25 fps
GMC_ROT_TOL, GMC_SHIFT_TOL = 1e-5, 1e-3  # the warp's 2x2 block and its translation (px)


def _sha256(data) -> str:
    import hashlib
    return hashlib.sha256(data).hexdigest()


def _video_fixture(card: str):
    """flight.avi against its digests (every packet, every decoded frame, fps and frame
    count), the decode ms a frame (median of 3 passes), then GMC("sparseOptFlow") on the
    frames against the JAX package's warps, its host ms a frame. Returns the frames."""
    from sar_yolo_tpu_torch.data.avi import AviReader
    from sar_yolo_tpu_torch.data.imageio import decode_mjpeg_frame
    from sar_yolo_tpu_torch.trackers.gmc import GMC
    digests = json.loads((VIDEO_DIR / "digests.json").read_text())
    reader = AviReader(VIDEO_DIR / "flight.avi")
    check((reader.fps, reader.frame_count, len(reader)) == (digests["fps"], digests["frame_count"],
                                                           VIDEO_FRAMES),
          f"flight.avi: fps {reader.fps}, {reader.frame_count} frames in its header, "
          f"{len(reader)} in movi; the digests: {digests['fps']}, {digests['frame_count']}")
    packets = list(reader.packets())
    frames, decode_ms = [], []
    for _ in range(3):
        frames = []
        for packet in packets:
            t0 = time.perf_counter()
            frames.append(decode_mjpeg_frame(packet))
            decode_ms.append((time.perf_counter() - t0) * 1e3)
    for i, (packet, frame, entry) in enumerate(zip(packets, frames, digests["frames"])):
        check(_sha256(packet) == entry["packet_sha256"], f"flight.avi frame {i}: packet differs")
        check(list(frame.shape) == digests["shape"] and
              _sha256(frame.tobytes()) == entry["bgr_sha256"],
              f"flight.avi frame {i}: pixels differ from cv2.VideoCapture's")
    gmc, gmc_ms, rot, shift = GMC("sparseOptFlow"), [], 0.0, 0.0
    for frame, entry in zip(frames, digests["frames"]):
        t0 = time.perf_counter()
        warp = gmc.apply(frame)
        gmc_ms.append((time.perf_counter() - t0) * 1e3)
        ref = np.array(entry["gmc"])
        rot = max(rot, float(np.abs(warp[:, :2] - ref[:, :2]).max()))
        shift = max(shift, float(np.abs(warp[:, 2] - ref[:, 2]).max()))
    out = {"video_fixture": "tests/data/video/flight.avi", "frames": len(frames),
           "bytes": (VIDEO_DIR / "flight.avi").stat().st_size, "fps": reader.fps,
           "packets_and_pixels_matched": len(frames),
           "decode_ms_per_frame_median": statistics.median(decode_ms),
           "gmc_ms_per_frame_median": statistics.median(gmc_ms[1:]),
           "gmc_rot_err": rot, "gmc_shift_err_px": shift, "gmc_on": "host (numpy)",
           "card": card}
    print(json.dumps(out))
    check(rot <= GMC_ROT_TOL and shift <= GMC_SHIFT_TOL,
          f"GMC against the JAX package's warps: 2x2 {rot}, translation {shift} px")
    return frames


def _relabelled(ids: list) -> list:
    """Track ids per frame renumbered by first appearance (a second tracker of the process
    draws other numbers from the shared counter)."""
    first = {}
    return [[first.setdefault(i, len(first)) for i in frame] for frame in ids]


def phase_video(card: str, seed: int = 2) -> dict:
    """Phase 24: video sources and BoT-SORT's camera-motion compensation (see the module
    docstring). Returns the kernel launches by path."""
    import torch

    from sar_yolo_tpu_torch.data import loaders
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    from sar_yolo_tpu_torch.ops.decode import decode_detect
    from sar_yolo_tpu_torch.trackers.byte_tracker import BYTETracker, STrack
    from sar_yolo_tpu_torch.trackers.gmc import GMC
    t_phase = time.perf_counter()
    frames = _video_fixture(card)
    avi = VIDEO_DIR / "flight.avi"
    yolo = _perturbed_yolo("yolov13n-JDE.yaml", seed, TRAIN_IMGSZ)
    plain = copy.deepcopy(yolo)
    _set_flash(plain, False)
    meta, n_emb, n_states = yolo.meta, yolo.meta["embed_dim"], yolo.meta["state_classes"]
    predictor = yolo._get_predictor({"imgsz": TRAIN_IMGSZ})
    with torch.no_grad():
        scores = torch.cat([decode_detect(predictor.model(predictor.preprocess(f[None])[0]),
                                          meta["strides"], meta["nc"], meta["reg_max"],
                                          extra_sigmoid=n_states, split_extras=n_emb)[0]
                            [..., 4:4 + meta["nc"]].flatten(1) for f in frames])
    conf, margin = _ab_conf(scores.double().cpu().numpy(), 300, margin=1e-4)
    kw = dict(imgsz=TRAIN_IMGSZ, conf=conf)
    kept = yolo.predict(str(avi), **kw)  # warm-up, and the scores the thresholds sit among
    kept_scores = np.concatenate([r.boxes.conf for r in kept])
    high, new = (_gap_threshold(kept_scores, q, margin) for q in (0.5, 0.7))
    root = Path("runs") / "chip_smoke_video"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    configs = _write_tracker_configs(root, high, conf, new, gmc_method="sparseOptFlow")
    r = TRAIN_IMGSZ / max(frames[0].shape[:2])
    box_tol = 32e-3 / r  # phase 10's bound: 1e-3 of the coarsest DFL bin, in frame pixels
    paths, track, file_ids, file_rows = {}, {}, {}, {}
    for name, cfg in configs.items():
        ids, rows = {}, {}
        for label, model in (("kernel", yolo), ("plain", plain)):
            decode_ms, update_ms, gmc_ms = [], [], []
            STrack._count = 0
            flash_area_attention.launches = 0
            t0 = time.perf_counter()
            with _timed_function(loaders, "decode_mjpeg_frame", decode_ms), \
                    _timed_function(BYTETracker, "update", update_ms), \
                    _timed_function(GMC, "apply", gmc_ms):
                res = model.track(str(avi), tracker=str(cfg), **kw)
            wall = time.perf_counter() - t0
            launches = flash_area_attention.launches
            ids[label] = [r.boxes.id.astype(int).tolist() for r in res]
            rows[label] = [r.boxes.data[:, :5] for r in res]
            trk = model._predictor_cache[1].trackers[str(avi)]
            check(len(res) == VIDEO_FRAMES and [r.frame for r in res] == list(range(VIDEO_FRAMES))
                  and trk.max_time_lost == int(25 / 30.0 * 30)
                  and (getattr(trk, "gmc", None) is not None) == (name == "botsort"),
                  f"YOLO.track {name} {label}: {len(res)} Results, frame rate of its tracker "
                  f"{trk.max_time_lost}")
            if label == "kernel":
                check(launches == VIDEO_FRAMES * LAUNCHES_PER_FORWARD,
                      f"YOLO.track {name} over flight.avi: {launches} kernel launches")
                paths[f"YOLO.track {name}"
                      f"{' (sparseOptFlow)' if name == 'botsort' else ''} flight.avi "
                      f"{VIDEO_FRAMES} frames @{TRAIN_IMGSZ}"] = launches
                forward = [r.speed["preprocess"] + r.speed["inference"] for r in res]
                track[name] = {"frames_per_s": VIDEO_FRAMES / wall,
                               "decode_ms": statistics.median(decode_ms),
                               "forward_ms": statistics.median(forward),
                               "gmc_plus_tracker_ms": statistics.median(update_ms),
                               "gmc_ms": statistics.median(gmc_ms[1:]) if gmc_ms else 0.0,
                               "kernel_launches": launches}
            else:
                check(launches == 0, f"YOLO.track {name}: use_flash=False launched the kernel")
        flat = [i for frame in ids["kernel"] for i in frame]
        check(ids["kernel"] == ids["plain"], f"YOLO.track {name} over flight.avi: ids "
              f"{ids['kernel']} on the kernel path, {ids['plain']} on the plain path")
        check(len(flat) > len(set(flat)) > 0, f"YOLO.track {name}: no identity crosses frames")
        box_err = max((float(np.abs(g[:, :4] - w[:, :4]).max()) for g, w in
                       zip(rows["kernel"], rows["plain"]) if len(g)), default=0.0)
        conf_err = max((float(np.abs(g[:, 4] - w[:, 4]).max()) for g, w in
                        zip(rows["kernel"], rows["plain"]) if len(g)), default=0.0)
        check(box_err <= box_tol and conf_err <= 1e-3,
              f"YOLO.track {name}: rows {box_err} px (bound {box_tol}), conf {conf_err}")
        track[name].update({"tracks": len(set(flat)), "rows": len(flat),
                            "box_err_px_vs_plain": box_err, "conf_err_vs_plain": conf_err})
        file_ids[name], file_rows[name] = ids["kernel"], rows["kernel"]

    # a .streams list of two copies of the file, every frame queued (stream_buffer)
    copies = [root / "a.avi", root / "b.avi"]
    for c in copies:
        shutil.copy(avi, c)
    streams = root / "two.streams"
    streams.write_text("".join(f"{c}\n" for c in copies))
    STrack._count = 0
    flash_area_attention.launches = 0
    t0 = time.perf_counter()
    res = yolo.track(str(streams), stream_buffer=True, tracker=str(configs["bytetrack"]), **kw)
    wall = time.perf_counter() - t0
    launches = flash_area_attention.launches
    check(launches == 2 * VIDEO_FRAMES * LAUNCHES_PER_FORWARD and len(res) == 2 * VIDEO_FRAMES,
          f".streams: {len(res)} Results, {launches} kernel launches")
    for i, c in enumerate(copies):
        mine = [r for r in res if r.path == str(c)]
        check([r.frame for r in mine] == list(range(VIDEO_FRAMES)),
              f".streams source {i}: frames {[r.frame for r in mine]}")
        check(_relabelled([r.boxes.id.astype(int).tolist() for r in mine])
              == _relabelled(file_ids["bytetrack"]),
              f".streams source {i}: tracks differ from the file's")
        err = max((float(np.abs(r.boxes.data[:, :5] - w).max()) for r, w in
                   zip(mine, file_rows["bytetrack"]) if len(w)), default=0.0)
        check(err <= box_tol, f".streams source {i}: rows {err} from the file's")
    paths[f"YOLO.track bytetrack .streams 2 x flight.avi, stream_buffer, {2 * VIDEO_FRAMES} "
          f"frames @{TRAIN_IMGSZ}"] = launches
    track["streams_buffer_frames_per_s"] = 2 * VIDEO_FRAMES / wall
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"yolo_track_video": f"yolov13n-JDE @{TRAIN_IMGSZ}, flight.avi "
                      f"{VIDEO_FRAMES} frames of 720x1280 at 25 fps", "conf": conf,
                      "high": high, "new": new, "box_tol_px": box_tol, **track,
                      "phase_s": time.perf_counter() - t_phase, "card": card}))
    return paths


TTA_LAUNCHES = 3 * LAUNCHES_PER_FORWARD  # the three passes of a frame
TUNE_ITERATIONS, TUNE_EPOCHS = 2, 1       # YOLO.tune on the card
AUTOBATCH_FRACTION = 0.8                  # of the card's memory a batch=-1 step may peak at


@contextlib.contextmanager
def _recorded_warnings():
    """While active, the port's logger warnings are appended to the yielded list (and still
    logged)."""
    from sar_yolo_tpu_torch.utils import LOGGER
    warned, orig = [], LOGGER.warning

    def record(msg, *args, **kwargs):
        warned.append(str(msg))
        return orig(msg, *args, **kwargs)
    LOGGER.warning = record
    try:
        yield warned
    finally:
        LOGGER.warning = orig


def _rows_array(results: list, max_det: int = 300) -> np.ndarray:
    """Detect Results as a (B, max_det, 6) array, padding rows zero."""
    out = np.zeros((len(results), max_det, 6), np.float32)
    for b, r in enumerate(results):
        out[b, :len(r)] = r.boxes.data[:, :6]
    return out


def _aattn_launches(model, last: int) -> int:
    """Kernel launches of a forward that stops after layer `last`: one an AAttn before it."""
    from sar_yolo_tpu_torch.nn.modules.block import AAttn
    return sum(isinstance(m, AAttn) for blk in model.blocks[:last + 1] for m in blk.modules())


def _modes_cli(jde, conf: float, root: Path, card: str) -> dict:
    """Phase 25's command line: `version` and `checks` in two subprocesses started together;
    `jde predict` of the 12 JPEG frames and `jde track` of flight.avi in process, the model a
    checkpoint of `jde`. Returns the kernel launches by path."""
    import os

    from sar_yolo_tpu_torch.cfg import entrypoint
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    t0 = time.perf_counter()
    env = {**os.environ, "SARYOLO_VERBOSE": "1"}
    procs = {mode: subprocess.Popen([sys.executable, "-m", "sar_yolo_tpu_torch", mode],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                    env=env) for mode in ("version", "checks")}
    outs = {}
    for mode, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=300)
        finally:
            p.kill()
        check(p.returncode == 0, f"python -m sar_yolo_tpu_torch {mode}: exit {p.returncode}, "
              f"{stderr[-2000:]}")
        outs[mode] = stdout
    import torch
    name = torch.cuda.get_device_name(0)
    check(outs["version"].strip().splitlines()[-1].startswith("sar_yolo_tpu_torch "),
          f"version printed {outs['version']!r}")
    check(f"device: {name}" in outs["checks"], f"checks did not name the card: {outs['checks']!r}")
    subprocess_s = time.perf_counter() - t0
    frames_dir, avi = JPEG_DIR / "frames", VIDEO_DIR / "flight.avi"
    ckpt = jde.save(root / "jde_ckpt")
    n_emb, n_states = jde.meta["embed_dim"], jde.meta["state_classes"]
    want = jde.predict(str(frames_dir), imgsz=TRAIN_IMGSZ, conf=conf)
    flash_area_attention.launches = 0
    t0 = time.perf_counter()
    got = entrypoint(["jde", "predict", f"model={ckpt}", f"source={frames_dir}",
                      f"imgsz={TRAIN_IMGSZ}", f"conf={conf}"])
    predict_s = time.perf_counter() - t0
    predict_launches = flash_area_attention.launches
    check(predict_launches == JPEG_FRAMES * LAUNCHES_PER_FORWARD,
          f"CLI jde predict: {predict_launches} kernel launches")
    kept, errs = _compare_detections(_results_array(got, n_emb, n_states),
                                     _results_array(want, n_emb, n_states), n_emb,
                                     "CLI jde predict vs YOLO.predict", by_row=True)
    check(max(errs.values()) <= 1e-5, f"CLI jde predict vs YOLO.predict: {errs}")
    flash_area_attention.launches = 0
    t0 = time.perf_counter()
    tracked = entrypoint(["jde", "track", f"model={ckpt}", f"source={avi}", f"imgsz={TRAIN_IMGSZ}",
                          f"conf={conf}"])
    track_s = time.perf_counter() - t0
    track_launches = flash_area_attention.launches
    check(track_launches == VIDEO_FRAMES * LAUNCHES_PER_FORWARD and len(tracked) == VIDEO_FRAMES
          and all(r.boxes.id is not None for r in tracked if len(r)),
          f"CLI jde track: {len(tracked)} Results, {track_launches} kernel launches")
    print(json.dumps({"cli": "python -m sar_yolo_tpu_torch version / checks (subprocesses), "
                      f"jde predict / track model=<checkpoint> @{TRAIN_IMGSZ}",
                      "subprocess_s": subprocess_s, "checks_device": name,
                      "predict_kept_per_frame": kept, **errs, "predict_s": predict_s,
                      "track_s": track_s, "predict_launches": predict_launches,
                      "track_launches": track_launches, "card": card}))
    return {f"CLI jde predict {JPEG_FRAMES} JPEG frames @{TRAIN_IMGSZ}": predict_launches,
            f"CLI jde track flight.avi {VIDEO_FRAMES} frames @{TRAIN_IMGSZ}": track_launches}


def _modes_tta(frames: list, root: Path, card: str, seed: int) -> tuple:
    """Phase 25's test-time augmentation on yolov13n: predict in float32 against the
    plain path and in bf16 against float32, and val. Returns (the model, launches by path,
    bf16 launches by path)."""
    import torch

    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention, reset_launches
    from sar_yolo_tpu_torch.ops.tta import forward_tta
    frames_dir = JPEG_DIR / "frames"
    det = _perturbed_yolo("yolov13n.yaml", seed, TRAIN_IMGSZ)
    _damp_class_logits(det, np.stack(frames[:DETECT_AB_BATCH]), TRAIN_IMGSZ)  # no tie at 1.0
    plain = copy.deepcopy(det)
    _set_flash(plain, False)
    meta, nc = det.meta, det.meta["nc"]
    predictor = det._get_predictor({"imgsz": TRAIN_IMGSZ})
    with torch.no_grad():
        preds = np.stack([forward_tta(predictor.model, predictor.preprocess(f[None])[0],
                                      meta["strides"], nc, meta["reg_max"])[0].double().cpu().numpy()
                          for f in frames])
    # a threshold where greedy NMS over the three passes' candidates keeps the same rows under
    # rounding (phase 14's rule)
    conf, margin = _nms_stable_conf(preds, nc, 0.7, DETECT_CANDIDATES)
    del preds
    kw = dict(imgsz=TRAIN_IMGSZ, conf=conf, augment=True)
    det.predict(str(frames_dir), **kw)  # warm-up: BN folding, cuDNN's plans at 640, 544, 448
    reset_launches()
    t0 = time.perf_counter()
    got = det.predict(str(frames_dir), **kw)
    tta_s = time.perf_counter() - t0
    launches = flash_area_attention.launches
    check(launches == JPEG_FRAMES * TTA_LAUNCHES and
          flash_area_attention.launches_by_dtype["float32"] == launches,
          f"YOLO.predict(augment=True): {launches} kernel launches for {JPEG_FRAMES} frames")
    want = plain.predict(str(frames_dir), **kw)
    check(flash_area_attention.launches == launches, "TTA: use_flash=False launched the kernel")
    r = TRAIN_IMGSZ / max(frames[0].shape[:2])
    box_tol = 32e-3 / r  # phase 10's bound: 1e-3 of the coarsest DFL bin, in frame pixels
    kept, errs = _compare_detections(_rows_array(got), _rows_array(want), 0, "YOLO.predict TTA",
                                     by_row=True)
    check(errs["box_err_px"] <= box_tol and errs["score_err"] <= min(1e-3, margin),
          f"YOLO.predict TTA kernel vs plain: {errs}, box tolerance {box_tol} px, threshold "
          f"margin {margin}")
    t0 = time.perf_counter()
    single = det.predict(str(frames_dir), imgsz=TRAIN_IMGSZ, conf=conf)
    single_s = time.perf_counter() - t0
    # half: 24 bf16 launches a frame; the three passes' predictions of the bf16 kernel path no
    # farther (relative L2) from the float32 plain path's than twice the bf16 plain path's
    hkw = {**kw, "half": True}
    det.predict(str(frames_dir), **hkw)  # warm-up: the bf16 copy
    reset_launches()
    got_h = det.predict(str(frames_dir), **hkw)
    half_launches = _check_bf16_launches(JPEG_FRAMES * TTA_LAUNCHES, "YOLO.predict TTA half")
    check(all(np.isfinite(x.boxes.data).all() for x in got_h) and sum(map(len, got_h)) > 0,
          "YOLO.predict TTA half: no finite rows")
    x32 = det._get_predictor({"imgsz": TRAIN_IMGSZ}).preprocess(np.stack(frames[:2]))[0]
    x16 = det._get_predictor({"imgsz": TRAIN_IMGSZ, "half": True}).preprocess(
        np.stack(frames[:2]))[0]

    def passes(m):
        return lambda inp: [forward_tta(m, inp.float(), meta["strides"], nc, meta["reg_max"])]
    maps = _maps_vs_f32(passes(det._fused_for_serving(True)), passes(plain._fused_for_serving(True)),
                        passes(plain._fused_for_serving()), x16, x32)
    check(maps["maps_bf16_kernel_vs_f32"] <= 2 * maps["maps_bf16_plain_vs_f32"],
          f"TTA half: kernel path {maps['maps_bf16_kernel_vs_f32']} from float32, plain path "
          f"{maps['maps_bf16_plain_vs_f32']}")
    # val: one synthetic batch of 16 through the three passes
    vkw = dict(data="synthetic", imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, augment=True,
               project=str(root))
    det.val(**vkw)  # warm-up at batch 16
    reset_launches()
    t0 = time.perf_counter()
    mk = det.val(**vkw)
    val_s = time.perf_counter() - t0
    val_launches = flash_area_attention.launches
    check(val_launches == TTA_LAUNCHES, f"YOLO.val(augment=True): {val_launches} launches")
    mp = plain.val(**vkw)
    metric_err = max(abs(mk[k] - mp[k]) for k in mk if not k.startswith("speed"))
    check(set(mk) == set(mp) and metric_err <= 1e-3,
          f"YOLO.val(augment=True) kernel vs plain: {mk} vs {mp}")
    print(json.dumps({"tta": f"yolov13n @{TRAIN_IMGSZ} (nc {nc}), {JPEG_FRAMES} JPEG frames of "
                      "720x1280, passes at 640, 544, 448 (Na 400, 289, 196)", "conf": conf,
                      "conf_margin": margin, "kept_per_frame": kept, **errs,
                      "box_tol_px": box_tol, "kernel_launches": launches,
                      "frames_per_s_tta": JPEG_FRAMES / tta_s,
                      "frames_per_s_single": JPEG_FRAMES / single_s,
                      "kept_per_frame_single": [len(x) for x in single],
                      "bf16_kernel_launches": half_launches["bfloat16"],
                      "kept_per_frame_bf16": [len(x) for x in got_h], **maps,
                      "val_ms_per_image": mk["speed/ms_per_image"], "val_s": val_s,
                      "val_launches": val_launches, "val_metric_err_vs_plain": metric_err,
                      "card": card}))
    return det, {f"YOLO.predict augment=True yolov13n {JPEG_FRAMES} JPEG frames @{TRAIN_IMGSZ}":
                 launches, f"YOLO.val augment=True yolov13n @{TRAIN_IMGSZ} b{TRAIN_BATCH}":
                 val_launches}, \
        {f"YOLO.predict augment=True half yolov13n {JPEG_FRAMES} JPEG frames @{TRAIN_IMGSZ}":
         half_launches["bfloat16"]}


def _modes_embed(jde, card: str) -> dict:
    """Phase 25's `YOLO.embed` of the 12 JPEG frames at the default layer, [6] and [6, 8],
    against the plain path. Returns the kernel launches by path."""
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    frames_dir = JPEG_DIR / "frames"
    plain = copy.deepcopy(jde)
    _set_flash(plain, False)
    plain._fused = plain._half = plain._predictor_cache = None  # jde's folded copy: the kernel's
    n = len(jde.model.specs)
    paths, out = {}, {}
    for layers in (None, [6], [6, 8]):
        last = max(layers or [n - 2])
        expected = JPEG_FRAMES * _aattn_launches(jde.model, last)
        flash_area_attention.launches = 0
        t0 = time.perf_counter()
        got = jde.embed(str(frames_dir), embed=layers, imgsz=TRAIN_IMGSZ)
        wall = time.perf_counter() - t0
        launches = flash_area_attention.launches
        check(launches == expected, f"YOLO.embed {layers}: {launches} kernel launches, "
              f"expected {expected}")
        want = plain.embed(str(frames_dir), embed=layers, imgsz=TRAIN_IMGSZ)
        check(flash_area_attention.launches == launches, "embed: use_flash=False launched")
        rel = max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want))
        check(len(got) == JPEG_FRAMES and rel <= 1e-4 and all(np.isfinite(g).all() for g in got),
              f"YOLO.embed {layers}: {len(got)} vectors, {rel} relative from the plain path")
        label = f"YOLO.embed {layers or f'default [{n - 2}]'} yolov13n-JDE {JPEG_FRAMES} JPEG frames"
        paths[f"{label} @{TRAIN_IMGSZ}"] = launches
        out[str(layers or "default")] = {"dim": int(got[0].shape[0]), "rel_err_vs_plain": rel,
                                         "launches": launches, "frames_per_s": JPEG_FRAMES / wall}
    check(out["[6]"]["launches"] < out["[6, 8]"]["launches"], "embed=[6] ran layer 8")
    print(json.dumps({"embed": f"yolov13n-JDE @{TRAIN_IMGSZ}", **out, "card": card}))
    return paths


def _modes_benchmark(det, card: str) -> dict:
    """Phase 25's `YOLO.benchmark` of yolov13n with the pt2 format on the synthetic set."""
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    shutil.rmtree("exports", ignore_errors=True)
    flash_area_attention.launches = 0
    t0 = time.perf_counter()
    rows = det.benchmark(imgsz=TRAIN_IMGSZ, formats=("pt2",), n_iter=10, data="synthetic")
    wall = time.perf_counter() - t0
    launches = flash_area_attention.launches
    shutil.rmtree("exports", ignore_errors=True)
    check([r["format"] for r in rows] == ["torch", "pt2"] and not any("error" in r for r in rows),
          f"YOLO.benchmark: {rows}")
    check(abs(rows[1]["mAP50-95"] - rows[0]["mAP50-95"]) <= 1e-3,
          f"YOLO.benchmark: pt2 mAP50-95 {rows[1]['mAP50-95']}, native {rows[0]['mAP50-95']}")
    # each format: 1 + 10 timed predicts and 8 scored images, 8 launches each
    check(launches == 2 * 19 * LAUNCHES_PER_FORWARD, f"YOLO.benchmark: {launches} launches")
    print(json.dumps({"benchmark": f"yolov13n @{TRAIN_IMGSZ}, synthetic, n_iter 10", "rows": rows,
                      "s": wall, "kernel_launches": launches, "card": card}))
    return {f"YOLO.benchmark yolov13n @{TRAIN_IMGSZ} (native and pt2 rows)": launches}


def _modes_tune(root: Path, card: str) -> dict:
    """Phase 25's `YOLO.tune` of yolov13n-JDE at 640 on the synthetic set, float32."""
    import csv
    import math

    from sar_yolo_tpu_torch import YOLO
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    shutil.rmtree(Path("runs") / "tune", ignore_errors=True)
    flash_area_attention.launches = 0
    t0 = time.perf_counter()
    with _recorded_warnings() as warned:
        best = YOLO("yolov13n-JDE.yaml").tune(iterations=TUNE_ITERATIONS, data="synthetic",
                                              epochs=TUNE_EPOCHS, batch=TRAIN_BATCH,
                                              imgsz=TRAIN_IMGSZ, amp=False,
                                              project=str(root / "tune"))
    wall = time.perf_counter() - t0
    launches = flash_area_attention.launches
    with open(Path("runs") / "tune" / "tune_results.csv") as f:
        rows = list(csv.DictReader(f))
    shutil.rmtree(Path("runs") / "tune", ignore_errors=True)
    fitness = [float(r["fitness"]) for r in rows]
    check(not [w for w in warned if "failed" in w], f"YOLO.tune: {warned}")
    check(len(rows) == TUNE_ITERATIONS and all(math.isfinite(f) for f in fitness),
          f"YOLO.tune: tune_results.csv rows {rows}")
    # each trial: 4 steps of 8 and one validation batch of 8 (phase 6's YOLO.train)
    check(launches == TUNE_ITERATIONS * 5 * LAUNCHES_PER_FORWARD, f"YOLO.tune: {launches} launches")
    print(json.dumps({"tune": f"yolov13n-JDE @{TRAIN_IMGSZ} b{TRAIN_BATCH}, {TUNE_ITERATIONS} "
                      f"iterations of {TUNE_EPOCHS} epoch, synthetic, float32",
                      "fitness": fitness, "best_fitness": best[0],
                      "trial_s": [float(r["seconds"]) for r in rows], "s": wall,
                      "kernel_launches": launches, "card": card}))
    return {f"YOLO.tune yolov13n-JDE @{TRAIN_IMGSZ} b{TRAIN_BATCH}, {TUNE_ITERATIONS} trials of "
            f"{TUNE_EPOCHS} epoch": launches}


def _modes_autobatch(root: Path, card: str) -> dict:
    """Phase 25's batch=-1: the trainer's autobatch for yolov13n-JDE at 640 in float32, then
    one train step at that batch and its peak memory."""
    import torch

    from sar_yolo_tpu_torch.data.build import DataLoader
    from sar_yolo_tpu_torch.data.dataset import SyntheticDataset
    from sar_yolo_tpu_torch.engine.trainer import JDETrainer
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    t0 = time.perf_counter()
    tr = JDETrainer({"model": "yolov13n-JDE.yaml", "data": "synthetic", "batch": -1,
                     "imgsz": TRAIN_IMGSZ, "amp": False, "epochs": 1,
                     "project": str(root / "autobatch")}, device="cuda")
    tr.setup()
    choose_s = time.perf_counter() - t0
    B = tr.args.batch
    check(B >= 1 and B & (B - 1) == 0, f"batch=-1 chose {B}")
    ds = SyntheticDataset(n=B, imgsz=TRAIN_IMGSZ, nc=3, max_labels=tr.args.max_labels, task="jde")
    batch = next(iter(DataLoader(ds, B, workers=8, shuffle=False)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_area_attention.launches = 0
    t0 = time.perf_counter()
    total, _ = tr.train_step(batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = flash_area_attention.launches
    peak, card_bytes = torch.cuda.max_memory_allocated(), torch.cuda.get_device_properties(0).total_memory
    out = {"autobatch": f"yolov13n-JDE @{TRAIN_IMGSZ}, float32", "batch": B,
           "choose_s": choose_s, "step_s": step_s, "peak_gib": peak / 2**30,
           "card_gib": card_bytes / 2**30, "peak_share": peak / card_bytes,
           "kernel_launches": launches, "card": card}
    print(json.dumps(out))
    check(bool(torch.isfinite(total)) and launches == LAUNCHES_PER_FORWARD,
          f"batch=-1 step: loss {total}, {launches} launches")
    check(peak <= AUTOBATCH_FRACTION * card_bytes, f"batch={B}: peak {peak} bytes of {card_bytes}")
    del tr, batch
    torch.cuda.empty_cache()
    return {f"train step batch=-1 (chose {B}) yolov13n-JDE @{TRAIN_IMGSZ}": launches}


def phase_modes(card: str, seed: int = 2) -> tuple:
    """Phase 25: the command line, test-time augmentation, embed, benchmark, tune and batch=-1
    (see the module docstring). Returns (float32 launches by path, bf16 launches by path)."""
    import torch

    from sar_yolo_tpu_torch.data.imageio import imread
    from sar_yolo_tpu_torch.ops.decode import decode_detect
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention
    t_phase = time.perf_counter()
    root = Path("runs") / "chip_smoke_modes"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    frames_dir = JPEG_DIR / "frames"
    frames = [imread(f) for f in sorted(frames_dir.glob("*.jpg"))]
    check(len(frames) == JPEG_FRAMES, f"{len(frames)} JPEG frames")
    laps, t = {}, time.perf_counter()

    def lap(label):
        nonlocal t
        laps[label], t = time.perf_counter() - t, time.perf_counter()

    jde = _perturbed_yolo("yolov13n-JDE.yaml", seed, TRAIN_IMGSZ)
    meta, n_emb, n_states = jde.meta, jde.meta["embed_dim"], jde.meta["state_classes"]
    predictor = jde._get_predictor({"imgsz": TRAIN_IMGSZ})
    with torch.no_grad():
        scores = torch.cat([decode_detect(predictor.model(predictor.preprocess(f[None])[0]),
                                          meta["strides"], meta["nc"], meta["reg_max"],
                                          extra_sigmoid=n_states, split_extras=n_emb)[0]
                            [..., 4:4 + meta["nc"]].flatten(1) for f in frames])
    conf, _ = _ab_conf(scores.double().cpu().numpy(), 300, margin=1e-4)
    paths = _modes_cli(jde, conf, root, card)
    lap("cli")
    # a JDE head warns and serves augment=False's rows
    kw = dict(imgsz=TRAIN_IMGSZ, conf=conf)
    want = jde.predict(str(frames_dir), **kw)
    flash_area_attention.launches = 0
    with _recorded_warnings() as warned:
        got = jde.predict(str(frames_dir), augment=True, **kw)
    launches = flash_area_attention.launches
    check(any("Detect-only" in w for w in warned) and launches == JPEG_FRAMES * LAUNCHES_PER_FORWARD
          and np.array_equal(_results_array(got, n_emb, n_states),
                             _results_array(want, n_emb, n_states)),
          f"yolov13n-JDE augment=True: warnings {warned}, {launches} launches")
    paths[f"YOLO.predict augment=True yolov13n-JDE (one scale) {JPEG_FRAMES} JPEG frames "
          f"@{TRAIN_IMGSZ}"] = launches
    det, tta_paths, bf16_paths = _modes_tta(frames, root, card, seed)
    paths.update(tta_paths)
    lap("tta")
    paths.update(_modes_embed(jde, card))
    lap("embed")
    paths.update(_modes_benchmark(det, card))
    lap("benchmark")
    del det, jde
    paths.update(_modes_tune(root, card))
    lap("tune")
    paths.update(_modes_autobatch(root, card))
    lap("autobatch")
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"modes": "phase 25", "parts_s": laps,
                      "phase_s": time.perf_counter() - t_phase, "card": card}))
    return paths, bf16_paths


ANNOTATE_FRAMES = 4          # auto_annotate's JPEG frames (sam_b at 1024)
SEG_ROWS = 20                # yolov8n-seg's rows of the Masks.xy frame


def _row_labels(res) -> list:
    """The label plot() writes for each box of `res`."""
    ids, out = res.boxes.id, []
    for i, row in enumerate(res.boxes.data):
        label = f"{res.names.get(int(row[5]), int(row[5]))} {row[4]:.2f}"
        if ids is not None:
            label = f"id:{int(ids[i])} " + label
        if res.person_states is not None:
            label += f" s{int(res.person_states[i])}"
        out.append(label)
    return out


def _row_region(row, label: str, lw: int, shape) -> tuple:
    """(y0, y1, x0, x1) that plot() can touch for one box: the rectangle grown by the line
    width and the label's Hershey extent at its origin (scale 0.5, thickness lw - 1)."""
    from sar_yolo_tpu_torch.data.hershey import BASE_LINE, CAP_LINE, GLYPHS
    x1, y1, x2, y2 = (int(v) for v in row[:4])
    ox, oy = x1, max(y1 - 3, 10)
    width = sum(ord(GLYPHS.get(ch, GLYPHS["?"])[1]) - ord(GLYPHS.get(ch, GLYPHS["?"])[0])
                for ch in label) * 0.5
    pad = lw + 2
    y0 = min(y1, y2, oy - int(CAP_LINE * 0.5)) - pad
    yb = max(y1, y2, oy + int(BASE_LINE * 0.5) + 1) + pad
    x0 = min(x1, x2, ox) - pad
    xb = max(x1, x2, ox + int(width) + 1) + pad
    return max(y0, 0), min(yb + 1, shape[0]), max(x0, 0), min(xb + 1, shape[1])


def _plot_rule(got: list, want: list, box_tol: float, label: str) -> dict:
    """Kernel path's plotted frames against the plain path's. A frame whose rows plot()
    reads alike in both paths (every box coordinate truncating to the same integer, the same
    class, track id and label) must be equal; in the others the frames may differ only
    inside the regions (box, line width, label extent) of the rows read differently. Returns
    the counts and the largest row difference."""
    exact, local, box_err = 0, 0, 0.0
    apart_by = {"coordinates": 0, "labels": 0}  # rows read differently, by what differs
    for i, (g, w) in enumerate(zip(got, want)):
        gb, wb = g.boxes.data, w.boxes.data
        check(gb.shape == wb.shape, f"{label} frame {i}: rows {gb.shape} vs {wb.shape}")
        if len(gb):
            box_err = max(box_err, float(np.abs(gb[:, :4] - wb[:, :4]).max()))
        gl, wl = _row_labels(g), _row_labels(w)
        coords = [not np.array_equal(gb[k, :4].astype(int), wb[k, :4].astype(int))
                  or not np.array_equal(gb[k, 5:], wb[k, 5:]) for k in range(len(gb))]
        apart = [k for k in range(len(gb)) if coords[k] or gl[k] != wl[k]]
        apart_by["coordinates"] += sum(coords)
        apart_by["labels"] += sum(gl[k] != wl[k] for k in range(len(gb)))
        gp, wp = g.plot(), w.plot()
        if not apart:
            check(np.array_equal(gp, wp), f"{label} frame {i}: the kernel path's plotted frame "
                  "differs from the plain path's")
            exact += 1
            continue
        lw = max(2, round(min(g.orig_shape) / 320))
        allowed = np.zeros(g.orig_shape, bool)
        for k in apart:
            for rows, labels in ((gb, gl), (wb, wl)):
                y0, y1, x0, x1 = _row_region(rows[k], labels[k], lw, g.orig_shape)
                allowed[y0:y1, x0:x1] = True
        diff = (gp != wp).any(-1)
        check(not (diff & ~allowed).any(), f"{label} frame {i}: {int((diff & ~allowed).sum())} "
              "pixels differ outside the rows the two paths read differently")
        local += 1
    check(box_err <= box_tol, f"{label}: rows {box_err} px from the plain path's (bound "
          f"{box_tol})")
    return {"frames_equal": exact, "frames_excluded": local, "rows_read_differently": apart_by,
            "box_err_px": box_err}


def _sam_mask_gain(sam) -> float:
    """Random weights give mask logits of ~0.1: the hypernetworks' last layers are scaled so
    that the first grid chunk's largest |logit| on the image set in `sam.predictor` is
    SAM_MASK_LOGIT (a trained SAM's scale), so the masks, their stability and their boxes
    have structure. Returns the gain."""
    import torch

    from sar_yolo_tpu_torch.models.sam.amg import build_point_grid
    p32 = sam.predictor
    h, w, nh, nw = p32._im_meta
    pts = build_point_grid(SAM_GRID[0])[:SAM_GRID[1], None] * np.float32([nw, nh])
    low, _ = p32.decode(pts, np.ones((len(pts), 1), np.float32))
    gain = SAM_MASK_LOGIT / low.abs().max().item()
    with torch.no_grad():
        for i in range(sam.model.mask_decoder.n_tokens):
            layer = getattr(sam.model.mask_decoder, f"hyper_mlp_{i}").l2
            layer.weight.mul_(gain)
            layer.bias.mul_(gain)
    return gain


def _check_contours(masks, xy, label: str) -> int:
    """Each Masks.xy contour: the largest outer contour of its mask by area, its points on
    the mask's border (inside it, a 4-neighbour outside it or the frame's edge). Returns the
    points checked."""
    from sar_yolo_tpu_torch.data.cv import contour_area, find_contours_external
    points = 0
    for k, (m, c) in enumerate(zip(masks, xy)):
        m = np.asarray(m, bool)
        check(c.dtype == np.float32 and c.ndim == 2 and c.shape[1] == 2,
              f"{label} mask {k}: contour {c.dtype} {c.shape}")
        if not m.any():
            check(len(c) == 0, f"{label} mask {k}: empty mask, {len(c)} contour points")
            continue
        pts = c.astype(int)
        check(len(pts) > 0 and np.array_equal(pts, c), f"{label} mask {k}: no contour")
        pad = np.pad(m, 1)
        x, y = pts[:, 0] + 1, pts[:, 1] + 1
        inside = pad[y, x]
        border = ~(pad[y - 1, x] & pad[y + 1, x] & pad[y, x - 1] & pad[y, x + 1])
        check(bool(inside.all() and border.all()), f"{label} mask {k}: contour points off the "
              "mask's border")
        areas = [contour_area(cc) for cc in find_contours_external(m.astype(np.uint8))]
        check(contour_area(c) == max(areas), f"{label} mask {k}: not the largest contour")
        points += len(pts)
    return points


def phase_annotate(card: str, seed: int = 2) -> tuple:
    """Phase 26: annotated output (see the module docstring). Returns the kernel launches by
    path, float32 and bfloat16."""
    import torch

    from sar_yolo_tpu_torch import SAM
    from sar_yolo_tpu_torch.data.annotator import auto_annotate
    from sar_yolo_tpu_torch.data.avi import AviReader
    from sar_yolo_tpu_torch.data.imageio import decode_mjpeg_frame, encode_jpeg, imread
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention, reset_launches
    from sar_yolo_tpu_torch.ops.decode import decode_detect
    from sar_yolo_tpu_torch.trackers.byte_tracker import STrack
    t_phase = time.perf_counter()
    frames_dir, avi = JPEG_DIR / "frames", VIDEO_DIR / "flight.avi"
    files = sorted(frames_dir.glob("*.jpg"))
    yolo = _perturbed_yolo("yolov13n-JDE.yaml", seed, TRAIN_IMGSZ)
    plain = copy.deepcopy(yolo)
    _set_flash(plain, False)
    meta = yolo.meta
    # phase 10's threshold: under max_det candidates a frame, in a gap of the scores
    predictor = yolo._get_predictor({"imgsz": TRAIN_IMGSZ})
    with torch.no_grad():
        scores = torch.cat([decode_detect(predictor.model(predictor.preprocess(imread(f)[None])[0]),
                                          meta["strides"], meta["nc"], meta["reg_max"],
                                          extra_sigmoid=meta["state_classes"],
                                          split_extras=meta["embed_dim"])[0]
                            [..., 4:4 + meta["nc"]].flatten(1) for f in files])
    conf, margin = _ab_conf(scores.double().cpu().numpy(), 300, margin=1e-4)
    root = Path("runs") / "chip_smoke_annotate"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    kw = dict(imgsz=TRAIN_IMGSZ, conf=conf, project=str(root), exist_ok=True)
    box_tol = 32e-3 / (TRAIN_IMGSZ / 1280)  # phase 10's bound in the frames' pixels
    paths, paths_bf16, out = {}, {}, {"conf": conf, "box_tol_px": box_tol}

    # YOLO.predict(save=True) of the JPEG frames: every file is the JPEG of its plot()
    # warm-up, with save: the host encoder is built here, not in the timed run
    yolo.predict(str(frames_dir), save=True, name="warmup", **kw)
    t0 = time.perf_counter()
    yolo.predict(str(frames_dir), imgsz=TRAIN_IMGSZ, conf=conf)
    out["frames_per_s_save_off"] = JPEG_FRAMES / (time.perf_counter() - t0)
    reset_launches()
    t0 = time.perf_counter()
    got = yolo.predict(str(frames_dir), save=True, name="predict", **kw)
    out["frames_per_s_save_on"] = JPEG_FRAMES / (time.perf_counter() - t0)
    launches = flash_area_attention.launches
    check(launches == JPEG_FRAMES * LAUNCHES_PER_FORWARD,
          f"YOLO.predict(save=True): {launches} kernel launches")
    paths[f"YOLO.predict save=True {JPEG_FRAMES} JPEG frames 720x1280 @{TRAIN_IMGSZ}"] = launches
    plot_ms, encode_ms = [], []
    for r in got:
        t0 = time.perf_counter()
        img = r.plot()
        t1 = time.perf_counter()
        data = encode_jpeg(img)
        plot_ms.append((t1 - t0) * 1e3)
        encode_ms.append((time.perf_counter() - t1) * 1e3)
        written = (root / "jde" / "predict" / Path(r.path).name).read_bytes()
        check(written == data, f"YOLO.predict(save=True) {Path(r.path).name}: the file is not "
              "the JPEG of plot()")
    out.update(plot_ms_median=statistics.median(plot_ms), encode_ms_median=statistics.median(
        encode_ms), rows_per_frame=[len(r) for r in got])
    want = plain.predict(str(frames_dir), save=True, name="predict_plain", **kw)
    out["predict_vs_plain"] = _plot_rule(got, want, box_tol, "YOLO.predict(save=True)")
    for r in want:
        name = Path(r.path).name
        check((root / "jde" / "predict_plain" / name).read_bytes() == encode_jpeg(r.plot()),
              f"YOLO.predict(save=True) plain {name}: the file is not the JPEG of plot()")

    # save_crop of one frame
    r = got[0]
    r.save_crop(root / "crops")
    h, w = r.orig_shape
    crops = 0
    for i, row in enumerate(r.boxes.data):
        x1, y1, x2, y2 = (int(np.clip(v, 0, lim)) for v, lim in zip(row[:4], (w, h, w, h)))
        f = root / "crops" / str(r.names.get(int(row[5]), int(row[5]))) / f"{Path(r.path).stem}_{i}.jpg"
        if x2 <= x1 or y2 <= y1:
            check(not f.exists(), f"save_crop: {f} of a box of no area")
            continue
        check(f.read_bytes() == encode_jpeg(r.orig_img[y1:y2, x1:x2]), f"save_crop: {f}")
        crops += 1
    check(crops > 0 and crops == len(list((root / "crops").rglob("*.jpg"))),
          f"save_crop: {crops} crops")
    out["save_crop_files"] = crops

    # YOLO.track(save=True) of flight.avi with ByteTrack: the AVI holds the plotted frames
    kept = np.concatenate([r.boxes.conf for r in got])
    high, new = (_gap_threshold(kept, q, margin) for q in (0.5, 0.7))
    cfg = _write_tracker_configs(root, high, conf, new)["bytetrack"]
    tracks = {}
    for label, model in (("kernel", yolo), ("plain", plain)):
        STrack._count = 0
        reset_launches()
        t0 = time.perf_counter()
        tracks[label] = model.track(str(avi), tracker=str(cfg), save=True, name=f"track_{label}",
                                    **kw)
        wall = time.perf_counter() - t0
        launches = flash_area_attention.launches
        if label == "kernel":
            check(launches == VIDEO_FRAMES * LAUNCHES_PER_FORWARD,
                  f"YOLO.track(save=True): {launches} kernel launches")
            paths[f"YOLO.track save=True bytetrack flight.avi {VIDEO_FRAMES} frames "
                  f"@{TRAIN_IMGSZ}"] = launches
            out["track_frames_per_s_save_on"] = VIDEO_FRAMES / wall
        else:
            check(launches == 0, "YOLO.track(save=True): use_flash=False launched the kernel")
        path = root / "jde" / f"track_{label}" / "flight.avi"
        reader = AviReader(path)
        packets = list(reader.packets())
        check((reader.fps, reader.frame_count, len(packets), reader.fourcc) ==
              (25.0, VIDEO_FRAMES, VIDEO_FRAMES, "MJPG")
              and decode_mjpeg_frame(packets[0]).shape == (720, 1280, 3),
              f"YOLO.track(save=True) {label}: {path} reads back as {reader.fps} fps, "
              f"{reader.frame_count} frames")
        for i, (r, packet) in enumerate(zip(tracks[label], packets)):
            check(packet == encode_jpeg(r.plot()), f"YOLO.track(save=True) {label} frame {i}: "
                  "the AVI's frame is not the JPEG of plot()")
        out[f"avi_bytes_{label}"] = path.stat().st_size
    ids = {k: [r.boxes.id.astype(int).tolist() for r in v] for k, v in tracks.items()}
    check(ids["kernel"] == ids["plain"] and sum(map(len, ids["kernel"])) > 0,
          f"YOLO.track(save=True): ids {ids['kernel']} on the kernel path, {ids['plain']} on "
          "the plain path")
    out["track_vs_plain"] = _plot_rule(tracks["kernel"], tracks["plain"], box_tol,
                                       "YOLO.track(save=True)")

    # half=True predict with save
    reset_launches()
    half = yolo.predict(str(frames_dir), save=True, half=True, name="predict_half", **kw)
    by = _check_bf16_launches(JPEG_FRAMES * LAUNCHES_PER_FORWARD, "YOLO.predict(half, save)")
    paths_bf16[f"YOLO.predict half save=True {JPEG_FRAMES} JPEG frames"] = by["bfloat16"]
    for r in half:
        check((root / "jde" / "predict_half" / Path(r.path).name).read_bytes()
              == encode_jpeg(r.plot()), f"YOLO.predict(half, save) {r.path}")

    # Masks.xy of a yolov8n-seg frame (no area attention in it)
    seg = _perturbed_yolo("yolov8n-seg.yaml", seed, TRAIN_IMGSZ)
    res = seg.predict(str(files[0]), imgsz=TRAIN_IMGSZ, conf=0.0, max_det=SEG_ROWS)[0]
    t0 = time.perf_counter()
    xy = res.masks.xy
    out["masks_xy_ms"] = (time.perf_counter() - t0) * 1e3
    out["masks_xy_points"] = _check_contours(res.masks.data, xy, "Masks.xy yolov8n-seg")
    out["masks_nonempty"] = int(sum(bool(np.asarray(m).any()) for m in res.masks.data))
    check(out["masks_nonempty"] > 0, "Masks.xy: every mask of the yolov8n-seg frame is empty")
    del seg

    # auto_annotate of 4 frames: the detector on the kernel path, sam_b at 1024
    data = root / "auto_frames"
    data.mkdir()
    for f in files[:ANNOTATE_FRAMES]:
        shutil.copy(f, data / f.name)
    sam = SAM("sam_b")
    check(sam.device.type == "cuda", f"sam_b built on {sam.device}")
    sam.predictor.set_image(imread(files[0]))
    out["sam_mask_gain"] = _sam_mask_gain(sam)
    reset_launches()
    t0 = time.perf_counter()
    labels = auto_annotate(data, det_model=yolo, sam_model=sam, conf=conf, imgsz=TRAIN_IMGSZ,
                           output_dir=root / "auto_labels")
    out["auto_annotate_s_per_frame"] = (time.perf_counter() - t0) / ANNOTATE_FRAMES
    launches = flash_area_attention.launches
    check(launches == ANNOTATE_FRAMES * LAUNCHES_PER_FORWARD,
          f"auto_annotate: {launches} kernel launches")
    paths[f"auto_annotate {ANNOTATE_FRAMES} JPEG frames (detector @{TRAIN_IMGSZ}, sam_b "
          "@1024)"] = launches
    polygons, points = 0, 0
    for f in files[:ANNOTATE_FRAMES]:
        lines = (labels / f"{f.stem}.txt").read_text().splitlines()
        for line in lines:
            v = line.split()
            coords = np.float64(v[1:])
            check(v[0] == "0" and len(coords) >= 6 and len(coords) % 2 == 0
                  and all(len(c.split(".")[1]) == 6 for c in v[1:])
                  and bool(((coords >= 0) & (coords <= 1)).all()),
                  f"auto_annotate {f.stem}.txt: line {line[:80]}")
            points += len(coords) // 2
        polygons += len(lines)
    check(polygons > 0, "auto_annotate: no polygon")
    out.update(auto_annotate_polygons=polygons, auto_annotate_points=points)
    del sam
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"annotate": f"yolov13n-JDE @{TRAIN_IMGSZ}, {JPEG_FRAMES} JPEG frames and "
                      f"flight.avi ({VIDEO_FRAMES} frames) of 720x1280", **out,
                      "phase_s": time.perf_counter() - t_phase, "card": card}))
    return paths, paths_bf16


# phase 27: the validator's and trainer's figures
PLOT_ROWS = 40            # rows an image the threshold leaves at most (drawn and in the matrix)
PLOT_MARGIN = 1e-3        # the threshold's least distance to a row's class logit
PLOT_CONF = 0.3           # the val threshold there: over the confusion matrix's 0.25
PLOT_BOX_TOL = 32e-3      # px: a drawn row against its plain-path pair (phase 10's bound)
OBB_PLOT_BATCH = 8        # the OBB val batch at 1024 (a 3 x 3 mosaic)


@contextlib.contextmanager
def _figure_calls():
    """While active, the host ms of each figure the validators and the trainer draw (by
    function), and each confusion matrix they plot."""
    from sar_yolo_tpu_torch.engine import trainer, validator
    from sar_yolo_tpu_torch.utils import plotting
    times, matrices, saved = {}, [], []

    def wrap(owner, name, label):
        fn = getattr(owner, name)

        def timed(*args, **kw):
            if label == "confusion_matrix":
                matrices.append(args[0].matrix.copy())
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                times.setdefault(label, []).append((time.perf_counter() - t0) * 1e3)
        saved.append((owner, name, fn))
        setattr(owner, name, timed)
    for mod, names in ((validator, ("plot_images", "plot_predictions")),
                       (trainer, ("plot_images", "plot_labels", "plot_results"))):
        for name in names:
            wrap(mod, name, f"{mod.__name__.rsplit('.', 1)[-1]}.{name}")
    wrap(plotting.ConfusionMatrix, "plot", "confusion_matrix")
    try:
        yield times, matrices
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def _rows_threshold(seen: list, conf_col: int, n: int) -> tuple:
    """(logit threshold, its margin): the middle of the lowest gap, wider than 2
    PLOT_MARGIN, between the rows' class logits of all paths, over which each image has
    under n rows in every path and the same number in each. `seen`: per path, batches of
    (B, 300, C) rows."""
    paths = []
    for path in seen:
        s = np.concatenate([b[..., conf_col] for b in path]).astype(np.float64)
        lg = np.full(s.shape, -np.inf)
        lg[s > 0] = np.log(s[s > 0] / (1 - s[s > 0]))
        paths.append(lg)
    level = max(np.sort(lg, 1)[:, -n].max() for lg in paths)
    above = np.unique(np.concatenate([lg[lg > level] for lg in paths]))
    for a, b in zip(above[:-1], above[1:]):
        t = (a + b) / 2
        counts = [(lg > t).sum(1) for lg in paths]
        if b - a > 2 * PLOT_MARGIN and all(np.array_equal(c, counts[0]) for c in counts):
            return float(t), float((b - a) / 2)
    check(False, f"no gap of the rows' logits over {level} splits every path alike")


def _probe_shift(models: list, v_cls, conf_col: int, runs: list) -> tuple:
    """Shift the class logits of `models` (the paths of one model, their class logits
    damped to MAX_LOGIT, so that no float32 score rounds to 1 and NMS never orders rows tied
    at 1.0) so that PLOT_CONF lies in a gap of every path's row scores that leaves under
    PLOT_ROWS rows an image (`_rows_threshold`), over the val calls `runs` (kwargs of
    `val` at conf 0.001, plots off). Returns (the shift, the margin in logits)."""
    seen = []
    for model in models:
        seen.append([])
        for kw in runs:
            with _recorded_dets(v_cls) as s:
                model.val(plots=False, **kw)
            seen[-1] += s
    level, margin = _rows_threshold(seen, conf_col, PLOT_ROWS)
    shift = float(np.log(PLOT_CONF / (1 - PLOT_CONF))) - level
    for model in models:
        _shift_class_logits(model, shift)
    return shift, margin


def _lift_rows(model, v_cls, conf_col: int, kw: dict, k: int = 10) -> float:
    """Where the median image's k-th best row scores under 0.25 (nothing to draw), shift
    `model`'s class logits so that it scores 0.5. Returns the shift."""
    with _recorded_dets(v_cls) as seen:
        model.val(plots=False, **kw)
    s = np.sort(np.concatenate([b[..., conf_col] for b in seen]).astype(np.float64), 1)
    kth = float(np.median(s[:, -k]))
    if not 0 < kth < 0.25:
        return 0.0
    shift = -float(np.log(kth / (1 - kth)))
    _shift_class_logits(model, shift)
    return shift


def _shift_class_logits(yolo, shift: float) -> int:
    """Add `shift` to the head's class-logit biases (each `cv3_*_pred.bias`); drops the
    serving caches. Returns the tensors shifted."""
    import torch
    head = yolo.model.blocks[yolo.meta["head_index"]]
    n = 0
    with torch.no_grad():
        for name, p in head.named_parameters():
            if name.startswith("cv3_") and name.endswith("_pred.bias"):
                p.add_(shift)
                n += 1
    check(n > 0, f"{yolo.cfg}: no class-logit bias in the head")
    yolo._fused = yolo._half = yolo._predictor_cache = None
    return n


def _decoded_size(path: Path) -> tuple:
    from sar_yolo_tpu_torch.data.imageio import imread
    img = imread(path)
    check(img is not None and img.dtype == np.uint8 and img.ndim == 3,
          f"{path}: does not decode")
    return img.shape[:2]


def _mosaic_size(n: int, hw: tuple) -> tuple:
    cols = int(np.ceil(np.sqrt(min(n, 16))))
    return int(np.ceil(min(n, 16) / cols)) * hw[0], cols * hw[1]


def _check_figures(d: Path, want: dict, label: str):
    """Each figure of `want` (name: (h, w)) in d, decoding at that size, and no other."""
    from sar_yolo_tpu_torch.utils.plotting import FIGURES
    got = {p.name for p in d.iterdir() if p.name in FIGURES}
    check(got == set(want), f"{label}: figures {sorted(got)}, expected {sorted(want)}")
    for name, hw in want.items():
        size = _decoded_size(d / name)
        check(size == hw, f"{label}: {name} decodes at {size}, expected {hw}")


def _drawn_rows(rows: np.ndarray, conf_col: int, thr: float) -> list:
    """What the prediction mosaic reads of one image's rows: (int corners or xywhr, class,
    label confidence) of the rows at or over thr."""
    return [(tuple(int(v) for v in r[:conf_col]), int(r[conf_col + 1]), f"{r[conf_col]:.2f}")
            for r in rows if r[conf_col] >= thr]


def _compare_plots(kdir: Path, pdir: Path, kseen: list, pseen: list, kcm, pcm, thr: float,
                   margin: float, label: str) -> dict:
    """Kernel path's figures against the plain path's: the confusion matrices equal, the
    labels mosaic byte for byte; the first batch's drawn rows equal (then the prediction
    mosaic byte for byte), or each row read differently within PLOT_BOX_TOL of its pair,
    with a coordinate truncating to another integer, a label rounding apart or a score
    within the threshold's margin. Returns the counts and the largest box difference."""
    check(len(kcm) == len(pcm) == 1 and np.array_equal(kcm[0], pcm[0]),
          f"{label}: confusion matrices {[m.tolist() for m in kcm]} vs "
          f"{[m.tolist() for m in pcm]}")
    check((kdir / "val_batch0_labels.jpg").read_bytes() ==
          (pdir / "val_batch0_labels.jpg").read_bytes(), f"{label}: the labels mosaics differ")
    apart, drawn, box_err = 0, 0, 0.0
    for g, w in zip(kseen[0], pseen[0]):
        gd, wd = _drawn_rows(g, 4, thr), _drawn_rows(w, 4, thr)
        drawn += len(gd)
        gk, wk = g[g[:, 4] >= thr - margin], w[w[:, 4] >= thr - margin]
        check(len(gk) == len(wk), f"{label}: {len(gk)} rows over the threshold, {len(wk)} on "
              "the plain path")
        errs = [np.abs(wk[:, :4] - r[:4]).max(1) for r in gk]
        for r, e in zip(gk, errs):
            j = int(e.argmin())
            box_err = max(box_err, float(e[j]))
            check(e[j] <= PLOT_BOX_TOL and wk[j, 5] == r[5], f"{label}: row {r[:6].tolist()} "
                  f"has no pair in the plain path within {PLOT_BOX_TOL} px (nearest "
                  f"{wk[j, :6].tolist()}); kernel rows {gk[:, :6].tolist()}, plain rows "
                  f"{wk[:, :6].tolist()}")
            if sorted(gd) != sorted(wd) and \
                    _drawn_rows(r[None], 4, -1) != _drawn_rows(wk[j][None], 4, -1):
                near = np.abs(r[4] - thr) <= margin or any(
                    int(a) != int(b) for a, b in zip(r[:4], wk[j, :4])) or \
                    f"{r[4]:.2f}" != f"{wk[j, 4]:.2f}"
                check(near, f"{label}: row {r[:6].tolist()} read differently from "
                      f"{wk[j, :6].tolist()}")
                apart += 1
    if apart == 0:
        check((kdir / "val_batch0_pred.jpg").read_bytes() ==
              (pdir / "val_batch0_pred.jpg").read_bytes(),
              f"{label}: the prediction mosaics differ where the drawn rows are equal")
    check(drawn > 0, f"{label}: no row drawn at {thr}")
    return {"rows_drawn": drawn, "rows_read_differently": apart, "box_err_px": box_err,
            "confusion_matrix": kcm[0].tolist()}


def phase_plots(card: str, data: dict, pose_seg: dict, seed: int = 2) -> dict:
    """Phase 27: the figures of `plots` (see the module docstring). Deletes phase 8's and
    phase 17's datasets after. Returns the kernel launches by path."""
    from sar_yolo_tpu_torch import YOLO
    from sar_yolo_tpu_torch.engine.validator import JDEValidator, OBBValidator, \
        PoseValidator, SegmentValidator
    from sar_yolo_tpu_torch.ops.cuda.flash_attention import flash_area_attention, reset_launches
    t_phase = time.perf_counter()
    root = Path("runs") / "chip_smoke_plots"
    shutil.rmtree(root, ignore_errors=True)
    cm = (600, 720)  # (6, 5) inches at 120 dpi
    paths, out = {}, {}
    # seeded weights, BN set to the statistics of the first val batch: activations keep their
    # scale through the depth on these frames (the noise calibration of `_perturbed_yolo`
    # leaves this model's rows here 1e-2 apart in score and pixels apart between the paths)
    from sar_yolo_tpu_torch.cfg.default import get_cfg
    from sar_yolo_tpu_torch.data import build
    from sar_yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset
    yolo = YOLO("yolov13n-JDE.yaml")
    yolo._ensure_variables(seed)
    ds = YOLODataset(check_det_dataset(data)["val"], imgsz=TRAIN_IMGSZ, hyp=get_cfg(),
                     use_tags=True, task="jde")
    first = next(iter(build.DataLoader(ds, TRAIN_BATCH, shuffle=False, drop_last=False)))
    calibrate_bn(yolo.model, JDEValidator.preprocess(first["img"], yolo.device))
    yolo._fused = None
    # NMS at IoU 1.0 suppresses nothing: rounding cannot decide which overlapping row stays
    kw = dict(data=data, imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, project=str(root), exist_ok=True,
              iou=1.0)
    n_val = len(DATA_VAL)
    # class logits damped to MAX_LOGIT on the val frames (perturbed weights spread them over
    # hundreds), then the threshold: from the rows of both batchings at conf 0.001, moved to
    # PLOT_CONF
    from sar_yolo_tpu_torch.data.imageio import imread
    files = sorted((Path(data["path"]) / "images" / "val").glob("*.png"))
    frames = [imread(f) for f in files]
    out["class_logit_gain"] = [_damp_class_logits(yolo, [f for f in frames if f.shape == hw],
                                                  TRAIN_IMGSZ)
                               for hw in sorted({f.shape for f in frames})]
    del frames
    plain = copy.copy(yolo)
    plain.model, plain._fused = copy.deepcopy(yolo.model), None
    _set_flash(plain, False)
    shift, margin = _probe_shift([yolo, plain], JDEValidator, 4,
                                 [dict(rect=r, name="probe", **kw) for r in (False, True)])
    out["class_logit_shift"] = shift
    conf = PLOT_CONF
    with _figure_calls() as (times, matrices):
        for rect, hw in ((False, (TRAIN_IMGSZ, TRAIN_IMGSZ)), (True, RECT_SHAPES[0])):
            tag = "rect" if rect else "square"
            runs = {}
            for path, model in (("kernel", yolo), ("plain", plain)):
                n_cm = len(matrices)
                reset_launches()
                with _recorded_dets(JDEValidator) as seen:
                    model.val(rect=rect, conf=conf, name=f"val_{tag}_{path}", **kw)
                launches = flash_area_attention.launches
                runs[path] = (root / "jde" / f"val_{tag}_{path}", seen, matrices[n_cm:])
                if path == "kernel":
                    n_batches = -(-n_val // TRAIN_BATCH)
                    check(launches == n_batches * LAUNCHES_PER_FORWARD,
                          f"YOLO.val {tag} plots: {launches} kernel launches")
                    paths[f"YOLO.val plots {tag} yolov13n-JDE@{TRAIN_IMGSZ} b{TRAIN_BATCH}, "
                          f"{n_val} PNG frames"] = launches
                else:
                    check(launches == 0, f"YOLO.val {tag}: use_flash=False launched the kernel")
                _check_figures(runs[path][0], {"val_batch0_labels.jpg": _mosaic_size(
                    TRAIN_BATCH, hw), "val_batch0_pred.jpg": _mosaic_size(TRAIN_BATCH, hw),
                    "confusion_matrix.png": cm}, f"YOLO.val {tag} {path}")
            (kdir, kseen, kcm), (pdir, pseen, pcm) = runs["kernel"], runs["plain"]
            out[f"val_{tag}"] = _compare_plots(kdir, pdir, kseen, pseen, kcm, pcm, conf,
                                               margin * conf * (1 - conf),
                                               f"YOLO.val {tag} plots")

        # one epoch of training: the seven figures
        reset_launches()
        trained = YOLO("yolov13n-JDE.yaml")
        trained.train(data=data, imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, epochs=1, workers=8,
                      seed=seed, amp=False, project=str(root), name="train", exist_ok=True)
        launches = flash_area_attention.launches
        steps, n_batches = DATA_TRAIN // TRAIN_BATCH, -(-n_val // TRAIN_BATCH)
        check(launches == (steps + n_batches) * LAUNCHES_PER_FORWARD,
              f"YOLO.train plots: {launches} kernel launches")
        paths[f"YOLO.train plots 1 epoch @{TRAIN_IMGSZ} b{TRAIN_BATCH} ({steps} steps + "
              "the validation)"] = launches
        tdir = root / "jde" / "train"
        keys = (tdir / "results.csv").read_text().splitlines()[0].split(",")[1:]
        cols = min(4, len(keys))
        rows = -(-len(keys) // cols)
        mosaic = _mosaic_size(TRAIN_BATCH, (TRAIN_IMGSZ, TRAIN_IMGSZ))
        _check_figures(tdir, {"train_batch0.png": mosaic, "labels.jpg": (960, 1200),
                              "labels_correlogram.jpg": (1080, 1080),
                              "results.png": (360 * rows, 480 * cols), "confusion_matrix.png": cm,
                              "val_batch0_labels.jpg": mosaic, "val_batch0_pred.jpg": mosaic},
                       "YOLO.train plots")
        del trained

        # yolov8n-seg, -pose and -obb: their overlays
        for name, task, vdata, imgsz, batch, v_cls, conf_col, n_img in (
                ("yolov8n-seg.yaml", "segment", pose_seg["segment"], TRAIN_IMGSZ, TRAIN_BATCH,
                 SegmentValidator, 4, POSE_SEG_VAL),
                ("yolov8n-pose.yaml", "pose", pose_seg["pose"], TRAIN_IMGSZ, TRAIN_BATCH,
                 PoseValidator, 4, POSE_SEG_VAL),
                ("yolov8n-obb.yaml", "obb", "synthetic", OBB_IMGSZ, OBB_PLOT_BATCH, OBBValidator,
                 5, VAL_IMAGES)):
            model = _perturbed_yolo(name, seed, imgsz)
            vkw = dict(data=vdata, imgsz=imgsz, batch=batch, project=str(root), exist_ok=True)
            out[f"{task}_class_logit_shift"] = _lift_rows(model, v_cls, conf_col,
                                                          dict(name=f"probe_{task}", **vkw))
            with _recorded_dets(v_cls) as seen:
                model.val(name=f"val_{task}", **vkw)
            drawn = sum(len(_drawn_rows(r, conf_col, 0.25)) for r in seen[0])
            check(drawn > 0, f"YOLO.val {task} plots: no row drawn")
            want = {"val_batch0_labels.jpg": _mosaic_size(min(batch, n_img), (imgsz, imgsz)),
                    "val_batch0_pred.jpg": _mosaic_size(min(batch, n_img), (imgsz, imgsz))}
            if task != "obb":
                want["confusion_matrix.png"] = cm
            _check_figures(root / task / f"val_{task}", want, f"YOLO.val {task} plots")
            out[f"{task}_rows_drawn"] = drawn
            paths[f"YOLO.val plots {name.removesuffix('.yaml')}@{imgsz} (no A2C2f)"] = 0
            del model
    for d in (data["path"], *(v["path"] for v in pose_seg.values()), root):
        shutil.rmtree(d, ignore_errors=True)
    print(json.dumps({"plots": f"yolov13n-JDE @{TRAIN_IMGSZ} on {n_val} PNG frames 720x1280 "
                      "and 1280x720, square and rect; yolov8n-seg, -pose, -obb", **out,
                      "figure_ms": {k: statistics.median(v) for k, v in times.items()},
                      "figure_ms_all": times, "threshold_margin_logit": margin,
                      "launches": paths, "phase_s": time.perf_counter() - t_phase,
                      "card": card}))
    return paths


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import sar_yolo_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    laps = [t_start]

    def lap(label: str):  # each phase's seconds
        laps.append(time.perf_counter())
        print(json.dumps({"phase_s": {label: laps[-1] - laps[-2]}}))
    card = phase_card()
    lap("card")
    phase_build()
    lap("build")
    rows = phase_kernel()
    lap("kernel")
    serve_launches, _ = phase_serve("yolov13n-JDE.yaml", 640, 0.005, 1e-3, MAIN_BATCH, seed=0,
                                    throughput_batches=(1, 8))
    # At 1280, float32 rounding alone moves this random-weight model's boxes by
    # ~1e-2 px: its head maps lie ~1e-3 from the same model in float64 on the
    # plain path and ~3e-4 on the kernel path (phase_serve prints both and holds
    # the kernel path to the plain one's). The box bound there is 1e-3 of the
    # coarsest level's box-regression unit (a 32 px DFL bin at r = 1).
    p24_launches, _ = phase_serve("yolov13n-JDE_P24.yaml", 1280, 0.5, 32e-3, 1, seed=1,
                                  throughput_batches=(1,))
    lap("serve")
    step_launches, train_launches, _, yolo = phase_train(card)
    lap("train")
    seeded_val_launches, val_launches = phase_val(yolo, card)
    lap("val")
    del yolo
    disk_train_launches, rect_val_launches, host_loader, data = phase_data(card)
    lap("data")
    ckpt_launches = phase_checkpoint(card, data, host_loader)
    lap("checkpoint")
    jpeg_launches = phase_jpeg(card)
    lap("jpeg")
    half_launches = {
        f"serve half yolov13n-JDE@640 b{HALF_BATCH}": phase_half(
            "yolov13n-JDE.yaml", 640, 0.005, HALF_BATCH, 0, (1, HALF_BATCH), card),
        "serve half yolov13n-JDE_P24@1280 b1": phase_half(
            "yolov13n-JDE_P24.yaml", 1280, 0.5, 1, 1, (1,), card),
        f"YOLO.predict half {JPEG_FRAMES} JPEG frames x 3 calls": phase_half_jpeg(card)}
    lap("half")
    amp_launches, _ = phase_amp_train(card)
    lap("amp_train")
    detect_launches = phase_detect(card)
    lap("detect")
    cbam_launches = phase_cbam(card)
    lap("cbam")
    family_launches = phase_detect_family(card)
    lap("detect_family")
    pose_seg_launches, pose_seg_data = phase_pose_seg(card)
    lap("pose_seg")
    obb_cls_launches = phase_obb_cls(card)
    lap("obb_cls")
    rtdetr_world_launches = phase_rtdetr_world(card)
    lap("rtdetr_world")
    int8_row, int8_launches, int8_ddp_launches = phase_int8_ddp(card)
    lap("int8_ddp")
    export = phase_export(card)
    lap("export")
    sam_launches = phase_sam(card)
    lap("sam")
    sam2_launches = phase_sam2(card)
    lap("sam2")
    video_launches = phase_video(card)
    lap("video")
    modes_launches, modes_bf16_launches = phase_modes(card)
    lap("modes")
    annotate_launches, annotate_bf16_launches = phase_annotate(card)
    lap("annotate")
    plots_launches = phase_plots(card, data, pose_seg_data)
    lap("plots")

    # the kernel work of one forward at 640: 4 calls at the P4 shape and 4 at P5
    def per_forward(dname, batch):
        fwd = [r for r in rows if r["dtype"] == dname
               and r["shape"] in (f"640 P4 b{batch}", f"640 P5 b{batch}")]
        out = {key: 4 * sum(r[key] or 0.0 for r in fwd)
               for key in ("kernel_ms", "plain_ms", "library_ms", "backward_ms", "flops", "bytes")}
        t_ops, t_bytes = out["flops"] / PEAK_FLOPS[dname] * 1e3, out["bytes"] / PEAK_BYTES * 1e3
        out["bound_ms"] = max(t_ops, t_bytes)
        out["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        return out
    print(json.dumps({"kernel_per_forward": f"yolov12n served @640 b{BENCH_BATCH}",
                      **{d: {k: v for k, v in per_forward(d, BENCH_BATCH).items()
                             if k != "backward_ms"} for d in ("float32", "bfloat16")}}))
    # the main path's: one train step's forward (640, batch 16), in float32 (amp=False) and
    # in bf16 (amp, the default)
    total, total_bf16 = per_forward("float32", TRAIN_BATCH), per_forward("bfloat16", TRAIN_BATCH)
    total_b8 = per_forward("float32", EXPORT_BATCH)

    # test-time augmentation: each TTA shape, and one served frame's three passes (4 calls at
    # each P4 and P5 shape of 640, 544 and 448, batch 1)
    def tta(dname):
        keys = ("max_abs_err", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "stage_bytes", "Na")
        shapes = {r["shape"]: {k: r[k] for k in keys} for r in rows
                  if r["dtype"] == dname and r["shape"].startswith("TTA")}
        frame = [r for r in rows if r["dtype"] == dname and r["shape"] in (
            "640 P4 b1", "640 P5 b1", "TTA 544 P4 b1", "TTA 544 P5 b1", "TTA 448 P4 b1",
            "TTA 448 P5 b1")]
        per_frame = {k: 4 * sum(r[k] for r in frame) for k in ("kernel_ms", "plain_ms",
                                                                "library_ms", "flops", "bytes")}
        t_ops = per_frame["flops"] / PEAK_FLOPS[dname] * 1e3
        t_bytes = per_frame["bytes"] / PEAK_BYTES * 1e3
        per_frame.update(bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes")
        return {"shapes": shapes, "per_frame": per_frame}
    print(json.dumps({"kernels": [{
        "name": "flash_area_attention", "route": "cuda",
        "source": "sar_yolo_tpu_torch/csrc/flash_area_attention.cu",
        "replaces": "sar_yolo_tpu/ops/pallas/flash_attention.py:29",
        "launches": step_launches,
        "launches_by_dtype": {"float32": step_launches,
                              "bfloat16": amp_launches[f"amp train step forward @{TRAIN_IMGSZ} "
                                                       f"b{TRAIN_BATCH}"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "float32"),
        "ms": total["kernel_ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"], "bound_by": total["bound_by"],
        "library_ms": total["library_ms"], "plain_backward_ms": total["backward_ms"],
        "per": "launches, ms, plain_ms, library_ms, bound_ms and plain_backward_ms: one train "
               f"step's forward, yolov13n-JDE at 640, batch {TRAIN_BATCH}, float32 (amp=False); "
               "bfloat16: the same numbers of the amp train step's forward",
        "bfloat16": {"launches": amp_launches[f"amp train step forward @{TRAIN_IMGSZ} "
                                              f"b{TRAIN_BATCH}"],
                     "max_abs_err": max(r["max_abs_err"] for r in rows
                                        if r["dtype"] == "bfloat16"),
                     "ms": total_bf16["kernel_ms"], "plain_ms": total_bf16["plain_ms"],
                     "bound_ms": total_bf16["bound_ms"], "bound_by": total_bf16["bound_by"],
                     "library_ms": total_bf16["library_ms"],
                     "plain_backward_ms": total_bf16["backward_ms"]},
        "pt2_program": {
            "launches_per_forward": export["launches_per_forward"],
            "profiler_launches_per_forward": export["profiler_launches_per_forward"],
            "ms": export["kernel_ms_per_forward"],
            "eager_ms": export["eager_kernel_ms_per_forward"],
            "graph_replay_ms": total_b8["kernel_ms"], "plain_ms": total_b8["plain_ms"],
            "bound_ms": total_b8["bound_ms"], "bound_by": total_b8["bound_by"],
            "library_ms": total_b8["library_ms"],
            "per": f"one forward of the .pt2 artifact of yolov13n-JDE at {EXPORT_IMGSZ}, batch "
                   f"{EXPORT_BATCH}, float32: launches_per_forward is the launch count of its "
                   "b8 gate forward, profiler_launches_per_forward torch.profiler's kernel "
                   "count a forward; ms and eager_ms are torch.profiler's device time "
                   "of the kernel's 8 launches in the artifact's and in the eager served "
                   "forward; graph_replay_ms, plain_ms, bound_ms and library_ms phase 3's at "
                   "the same shapes"},
        "tta": {"per": "phase 3's times of the TTA shapes (Na 289 at 544, 196 at 448), and "
                       "of one augmented frame of yolov13n at 640, batch 1 (24 launches)",
                "float32": tta("float32"), "bfloat16": tta("bfloat16")},
        "launches_by_path_bfloat16": {**half_launches, **amp_launches,
                                      **detect_launches["bfloat16"], **cbam_launches["bfloat16"],
                                      **modes_bf16_launches, **annotate_bf16_launches},
        "launches_by_path": {f"serve yolov13n-JDE@640 b{MAIN_BATCH}": serve_launches,
                             "serve yolov13n-JDE_P24@1280 b1": p24_launches,
                             **train_launches,
                             f"YOLO.val yolov13n-JDE@{TRAIN_IMGSZ} b{TRAIN_BATCH}, seeded":
                                 seeded_val_launches,
                             f"YOLO.val yolov13n-JDE@{TRAIN_IMGSZ} b{TRAIN_BATCH}, trained":
                                 val_launches,
                             f"YOLO.train on a disk dataset @{TRAIN_IMGSZ} b{TRAIN_BATCH}, 2 "
                             f"epochs ({2 * (DATA_TRAIN // TRAIN_BATCH)} steps + 2 validations)":
                                 disk_train_launches,
                             f"YOLO.val rect @{TRAIN_IMGSZ} b{TRAIN_BATCH} (384x672, 672x384)":
                                 rect_val_launches, **ckpt_launches, **jpeg_launches,
                             **detect_launches["float32"], **cbam_launches["float32"],
                             **family_launches, **pose_seg_launches, **obb_cls_launches,
                             **rtdetr_world_launches, **int8_ddp_launches,
                             **export["paths"], **sam_launches, **sam2_launches,
                             **video_launches, **modes_launches,
                             **annotate_launches, **plots_launches}}, {
        "name": "int8_conv", "route": "cuda", "source": "sar_yolo_tpu_torch/csrc/int8_conv.cu",
        "replaces": "sar_yolo_tpu/nn/modules/conv.py:122",
        "replaces_note": "not a TPU kernel: XLA's int8 conv_general_dilated in Int8Conv2D",
        "launches": int8_launches[0], "max_abs_err": int8_row["max_abs_err"],
        "max_rel_err_float32_epilogue": int8_row["max_rel_err"],
        "ms": int8_row["kernel_ms"], "plain_ms": int8_row["plain_ms"],
        "bound_ms": int8_row["bound_ms"], "bound_by": int8_row["bound_by"],
        "library_ms": int8_row["int_mm_ms"],
        "library": "torch._int_mm on the unfolded matrices (int32 sums, unfold excluded)",
        "int_mm_with_unfold_ms": int8_row["int_mm_with_unfold_ms"],
        "cudnn_bf16_ms": int8_row["cudnn_bf16_ms"],
        "per": f"one int8 forward of yolov13n-JDE at {INT8_IMGSZ}, batch {INT8_BATCH} "
               "(int8=True); the int32 sums equal the plain version's at every call"}, {
        "name": "int8_quantize", "route": "cuda",
        "source": "sar_yolo_tpu_torch/csrc/int8_quant.cu",
        "replaces": "sar_yolo_tpu/nn/modules/conv.py:119",
        "replaces_note": "not a TPU kernel: XLA's abs-max, divide, round and clip of the "
                         "activations in Int8Conv2D (lines 119-120)",
        "launches": int8_launches[1],
        "max_abs_err": max(int8_row["quantize_xq_abs_err"], int8_row["quantize_sx_abs_err"]),
        "xq_max_abs_err": int8_row["quantize_xq_abs_err"],
        "sx_max_abs_err": int8_row["quantize_sx_abs_err"],
        "ms": int8_row["quantize_ms"], "plain_ms": int8_row["quantize_plain_ms"],
        "bound_ms": int8_row["quantize_bound_ms"], "bound_by": "bytes", "library_ms": None,
        "per": f"one int8 forward of yolov13n-JDE at {INT8_IMGSZ}, batch {INT8_BATCH} "
               "(int8=True; one cooperative launch a call); xq and sx equal the plain "
               "version's at every call"}]}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
