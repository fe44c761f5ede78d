#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA card: txt2img
serving in bf16 (with PLMS, DDIM and DPM-Solver++, from random weights, a
reference checkpoint file and a training run, with the safety checker,
through the pipeline and through the serving daemon), img2img, the int8
serving mode and the two conv modes, LDM training with its image logger
and validation, and the fused transformer-block experiment, all at SD v1
full width; then the training CLI's --base path at full width: VAE-GAN
training of the kl-f8 first stage, and the LAION 1.4B LDM with its BERT
trained; then the VQ-f4 models at full width: inpainting_big through the
inpaint CLI's pipeline and CelebA-HQ through sample_diffusion's main();
then the class-conditional ImageNet LDM cin256-v2 through
sample_diffusion's main(), and the super-resolution model bsr_sr through
SuperResPipeline and through the LDM's split_input_params tiling; then the
retrieval-augmented 768² RDM through knn2img's main() over an index from
train_searcher, and the first-stage extras (MergedRescaleEncoder and
-Decoder, TimestepVAEModel) at full width; last the VQ-f4 models' training
over seeded JPEG trees: the VQ-f4 VQ-GAN and the LSUN-bedrooms and bsr_sr
LDMs through --base, and the noisy-latent classifier; last the port's
parallelism at SD v1 full width: DDP with ZeRO-1 on NCCL at one rank, then
two ranks sharing the card over gloo (DDP training, sharded sampling,
tensor parallelism), and in both the first stages' data parallelism (the
kl-f8 VAE-GAN and the VQ-f4 VQ-GAN at full width); last the convergence run
of the ColoredShapes probe with its kill and exact resume, the int8 quality
gate on the model it trained, and the int8 agreement at SD v1 full width.

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and the exit code is not 0:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc builds sd_tpu_torch/csrc into build/sd_tpu_torch (git-ignored);
3. K1 flash attention and 4. K2 GEGLU feed-forward: each kernel against its
   plain PyTorch version at every shape of the serving path at batch 1 with
   guidance (B=2), of the training path at batch 4 and of the serving path at
   batch 8 (B=16), and (K2) at one ragged shape, bf16 inputs, the plain
   version computed in fp32 from the same inputs (one batch element at a time
   where its logits would pass 2 GiB); K1 also at the safety checker's vision
   towers (the untrained one, N=50, 4 heads of 16, and ViT-L/14, N=257, 16
   heads of 64, at batch 1 and 8) and at the VQ-f4 models' legacy attention
   blocks (VQ_FLASH_SHAPES: inpainting_big's d = 64, 96 and 128 at batch 1,
   CelebA-HQ's d = 32 at 14, 21 and 28 heads at batch 4, its decoder's
   mid-block) and at cin256-v2's and bsr_sr's (WIDE_FLASH_SHAPES: the
   one-head d = 384, 576 and 960 sites, K1's wide<576> and split plans, at
   batch 4 with guidance; SuperResPipeline's 9 tiles at the 8x level, 20
   heads of 32, and their decode's mid-block; the tiled LDM's 9 patches and
   its 225 decode patches), at K1's split plan (SPLIT_FLASH_SHAPES: d =
   640, 768 and 1024 at N = 1024 and 4096, the first-stage extras' one-head
   sites), at the 768² RDM's sites (RDM_FLASH_SHAPES: 14 to 56 heads of 32
   at N = 2304, 576, 144 and 36 with guidance at 4 samples, and its kl-f16
   decoder's d = 512 at N = 2304; K2 at its FF widths, RDM_FF_SHAPES, C up
   to 1792 with inner 7168) and at the VQ-f4 models' training paths
   (TRAIN_VQ_FLASH_SHAPES: the frozen encoder's mid-block at batches 48,
   64 and 16, the LSUN UNet's legacy blocks at batch 48, bsr_sr's
   at 64, the classifier's and its AttentionPool2d at 16), each group's sums
   logged apart; K1's row log-sum-exp (the statistic K3 reads) against its
   plain version too, and every K1 shape a second time with sharp logits (q
   times SHARP); K1's launch plan at each
   shape (blocks, shared memory, blocks per SM, waves) and K2's per GEMM (a
   block's rows and columns, stages, blocks, k splits, waves) at each shape;
   max abs error and the ms of each (CUDA events), the bound, and the ms of
   one PyTorch call computing the same function (scaled_dot_product_attention
   for K1; none for K2, whose yardstick is the unfused bf16 FF: F.linear,
   chunk, F.gelu, multiply, F.linear);
5. K3 flash-attention backward: at the training path's two shapes, at
   the first stage's mid-blocks (VAE_BWD_SHAPES, d = 512: K3's wide plan,
   with K1's output and row log-sum-exp checked there too; DP_VAE_BWD_SHAPES
   likewise, a rank's mid-blocks at two ranks) and at the VQ-f4
   models' training shapes (TRAIN_VQ_BWD_SHAPES), with plain and
   with sharp logits, dQ, dK and dV from K1 + K3 against the plain backward
   in fp32 on the same bf16 inputs; the yardstick is
   scaled_dot_product_attention's forward+backward minus its forward (the
   backend it picks logged); then, untimed, K1 (with its lse) and K3 at the
   1.4B phase's own attention shapes (LDM_1P4B_FLASH_SHAPES, _BWD_SHAPES:
   its UNet at 32x32 latents, its BERT, its encoder's mid-block) with plain
   and sharp logits, and K2 at its FF shapes (LDM_1P4B_FF_SHAPES), their
   errors in each kernel's max_abs_err;
6. reference: the tiny model in bf16 on the card against the same weights in
   fp32 on the CPU (plain versions), 5 PLMS steps, latents compared; then
   the fp32 opt-out: SD_TPU_PRECISION=fp32 builds the tiny model in fp32 on
   the card (TF32 off for matmul and cuDNN), which samples against its fp32
   CPU run, and one tiny training loss and its gradients in fp32 outside
   autocast against the CPU, with no K1, K2 or K3 launch; DDIM at eta 0 and
   1 (its noise drawn on the CPU and moved) and DPM-Solver++ at orders 2 and
   3, 5 steps each, on the tiny model against the CPU; img2img at strength
   0.5, DDIM 6, and the ancestral chain (p_sample_loop) over 8 timesteps,
   each from draws made on the CPU, against the CPU; the untrained safety
   checker's embeddings (its tower in bf16, K1 at both layers) against the
   CPU, and its flags equal at thresholds that flag none and all;
7. serving: SD v1 at full width (860M UNet, kl-f8 decoder, CLIP ViT-L/14
   text tower) with seeded random weights in bf16 serves three one-prompt
   requests at 512x512, PLMS 50 steps, guidance 7.5, through
   Txt2ImgPipeline.__call__; the launch counters, reset just before, must
   show K1 = 16 (S+1) + 1 and K2 = 16 (S+1) per request;
8. training reference: the tiny model at 128² images (64x64 latents, so its
   attention sites have N=1024 and take K3), one loss and its UNet gradients
   in bf16 autocast on the card against fp32 on the CPU with the same
   weights, batch, t and noise, each within its stated bound; then 20
   constant-LR steps on one fixed batch on the card, whose loss must fall;
9. training: SD v1 at full width (fp32 master weights and AdamW moments,
   bf16 autocast; frozen kl-f8 encoder and CLIP in bf16; use_checkpoint on),
   batch 4 of 512² synthetic images with 77-token captions, 5 steps through
   Trainer.fit as `python -m sd_tpu_torch.scripts.train` builds it. Every
   step: a finite loss, a finite non-zero gradient on every UNet parameter,
   and exactly K1 = 16 + 16 + 1, K2 = 32 and K3 = 10 launches; after the
   last step the image logger (its one PNG set; K1 = 16 x 20 + 9, K2 = 16 x
   20) and validation over 2 batches with the current UNet and the EMA
   shadow (both metrics finite; K1 = 4 x 17, K2 = 4 x 16, K3 = 0) with the
   monitored save of step_5.pt; at the end, non-zero AdamW moments on every
   parameter, the time and size of the checkpoint that fit saves on exit
   (in a temporary directory), and val/loss_simple_ema against the loss of
   the UNet holding the EMA shadow, recomputed in fresh autocast contexts
   from validation's draws (within EMA_VAL_TOL);
10. K4 int8 GEGLU-FF, K5 int8 attention ("qk" and "qkpv") and K6 int8
   dense: each kernel against its plain PyTorch version (fp32 on the same
   bf16 inputs, the same int8 codes) at every shape of the int8 serving
   path at batch 1 and batch 8, with the ms of the bf16 path the site takes
   otherwise (K2, K1, F.linear; for K6 also torch._int_mm on the same
   codes, the library's int8 product alone), and K4's, K5's and K6's launch
   plans at each shape; each
   kernel within its own bound (INT8_TOL), which the bf16 path's output
   (and, for K5 "qkpv", K5 "qk"'s) must exceed at every shape, so that a
   kernel skipping its quantization fails; K5 "qkpv" at d=40 too (its
   narrow kernel, on no serving path: within INT8_TOL, not timed);
11. int8 reference: the tiny model at 256² (attention at N=4096, the
   decoder's at N=16384) with every bucket in bf16 on the card against the
   same weights in fp32 on the CPU without int8, PLMS 5: relative L2 of the
   latents within the int8 agreement bound, and not identical to the
   card's bf16 run;
12. int8 serving: SD v1 with SD_TPU_INT8's "all" serves three requests with
   the bf16 phase's generators; per request K5 = 5 (S+1) + 1, K1 = 11 (S+1),
   K4 = 5 (S+1), K2 = 11 (S+1), K6 = 0 and one int8 conv per Conv3x3 call;
   request 0's latents within relative L2 0.10 of the bf16 request 0 and not
   identical (tools/int8_quality.py's flagship gate); then one request with
   every bucket (K6 = 64 (S+1), the decoder's K5 in "qkpv"); then one
   request at batch 8 (K4 = 11 (S+1)), its images/s beside a bf16 batch-8
   request;
13. K7 fused GroupNorm-apply + SiLU + conv3x3: against its plain version
   (fp32 on the same bf16 inputs) at every launch shape and flag set of the
   fused serving path (a block's first launch: prologue + moments; its
   second: prologue + bias + skip), given its weight repacked as the
   resnet blocks give it, with its launch plan and the ms of the unfused
   site (GroupNorm32, SiLU, F.conv2d with bias, + skip, and the next
   GroupNorm's statistics) and of cuDNN's conv alone on h; then, untimed,
   at the launches of TimestepVAEModel's fused blocks (TIMESTEP_FUSED_SHAPES,
   batch 4, C up to 1536); one gradient through K7's autograd function
   against the plain backward;
14. K8 and X3 Winograd F(2x2,3x3): given U (as Conv3x3 keeps it), against
   their plain versions and F.conv2d (cuDNN, the library yardstick) at
   every K8 site shape of the serving path, at the X3 experiment of
   tools/exp_winograd.py (timing_split) at its four levels at B=16, K8
   beside it, and at two ragged shapes (WINO_RAGGED); the launch plan the
   library chooses at each, the kernel's ms with U given and the whole
   call's; X3's launches are counted over that experiment;
15. conv-mode reference: the small UNet of tests/test_torch_conv_modes.py
   (model_channels 128, channel_mult [1, 2], 32² latents) in bf16 on the
   card with both modes against fp32 on the CPU;
16. conv-mode serving: SD v1 serves one request in each conv mode with the
   bf16 phase's generator 0: SD_TPU_FUSED_CONV=1, SD_TPU_CONV_IMPL=winograd,
   and both; exact K7 and K8 launches per request (from the gates: 8 UNet and
   10 decoder blocks fused; 21 UNet and 31 decoder Winograd sites alone,
   16 and 11 beside the fused blocks), K1 and K2 as in bf16, and each
   request's latents within relative L2 0.10 of the bf16 request 0's and
   not identical to them; then one more bf16 request, so that bf16 and the
   modes take turns on the card;
17. X1 and X2, the fused transformer-block kernels of the block experiment
   (tools/exp_block_kernel.py): each against its plain version (fp32 on the
   same bf16 inputs, the experiment's; X2's padded context rows non-zero,
   so that its mask shows) at SD v1's four transformer sites at B=16, the
   bound set by the branch, what the kernel adds to x, not by the output,
   with the ms of the unfused yardstick (the port's LayerNormFp32,
   CrossAttention with K1, FeedForward with K2), and X1∘X2 on a port
   BasicTransformerBlock against the block itself in bf16 (relative L2
   within BLOCK_AGREEMENT_TOL); each site logs X1's launch plans ([X1 plan])
   and X2's ([X2 plan]: the attention launch's row tile, blocks and column
   split, LN3's route, K2's plan of each GEMM); then X2 off the row tiles
   (X2_OFF_GRID: N = 100 against row tiles of 64 and 128, so a tile that
   straddled two batch elements' contexts would fail), checked, not timed;
18. the block experiment: `python -m sd_tpu_torch.scripts.exp_block_kernel`
   and `... tail` at their defaults (N=4096, C=320), through their main();
   the launches, reset just before each, must be exactly 2 + 2 x 30 X1 and
   K1 launches, then 2 + 2 x 30 X2 and K2 launches;
19. [serve ckpt]: a reference-layout SD v1 checkpoint (the model's keys,
   a UNet EMA shadow under model_ema.*, the schedule buffers, CLIP's
   position_ids; seeded, fp32 storage) written to a temporary directory,
   built through build_txt2img_pipeline(ckpt=...) with a synthetic CLIP
   vocabulary and the default untrained safety checker; the UNet equal bit
   for bit to the file's model keys in bf16; one batch-1 request at 512²,
   guidance 7.5, each with DDIM 50 at eta 0 and 1, DPM-Solver++ 20 and PLMS
   50 with negative prompts, with exactly K1 = 16 E + 1 + 2 and K2 = 16 E
   for E UNet evaluations (S + 1 for PLMS, S for DDIM and DPM-Solver++);
   map_batches over three requests equal to three calls in turn; then a
   synthetic HF-layout ViT-L/14 safety checker through safety_ckpt serves
   a batch-2 request (K1 = 16 E + 1 + 24, nothing flagged), and with its
   thresholds at -2 flags and replaces every image;
20. [serve run], after training (which keeps an EMA shadow for it): the
   run directory built through build_txt2img_pipeline(ckpt=<logdir>), the
   UNet equal to the EMA shadow in bf16, one DPM-Solver++ 20 request with
   exact counts;
21. [img2img]: SD v1 in bf16 through Img2ImgPipeline from a synthetic 512²
   init image, DDIM 50, guidance 7.5, batch 1, at strength 0.75 (K1 =
   16 t_enc + 2 with t_enc = 37: the encoder's and the decoder's
   mid-blocks; K2 = 16 t_enc) and at strength 0 (K1 = 2, K2 = 0); then
   `python -m sd_tpu_torch.scripts.img2img`'s main() from a PNG, DDIM 10;
22. [serve daemon]: sd_tpu_torch.scripts.serve's Server in this process
   (DPM-Solver++ 20, max batch 2, buckets 512² and 256², a 500 ms window,
   the default untrained safety checker, no watermark), both buckets
   warmed; one-prompt requests in turn, two requests from threads that
   share one execution, the same (prompt, seed) alone and coalesced (PNGs
   equal bit for bit: the daemon runs without cuDNN, whose bf16 conv gives
   a row a result that depends on its slot), a 256² request, a cold bucket
   and an unknown field refused, and one HTTP POST through http_server on
   127.0.0.1; exactly K1 = 16 E + 1 + 2 and K2 = 16 E per execution; then
   one UNet evaluation with its rows swapped under cuDNN as it is, with
   `deterministic`, with `benchmark` and without cuDNN (equal there), and
   its ms at B=2 (the daemon's batch at --max-batch 1, where it keeps
   cuDNN), 4 and 16 with and without cuDNN, in turns;
23. [first stage]: `python -m sd_tpu_torch.scripts.train --base
   sd_tpu_torch/configs/autoencoder_kl_32x32x4.yaml -t --no_images` in
   process with `model.params.lossconfig.params.disc_start=1` (the
   discriminator and the adaptive weight engaged from step 2): the kl-f8 VAE-GAN at batch 12,
   256², 3 steps through Trainer.fit; every step finite losses and exactly
   K1 = 4 and K3 = 2 (the mid-blocks at [12, 1024, 1, 512]); steps 1 and 2's
   rec_loss, nll_loss, kl_loss, g_loss and disc_loss, and step 1's
   gradients of both mid-blocks' q, k and v convs and of the encoder,
   against the same steps of a second build from the same seed with the
   plain attention, within FIRST_STAGE_LOSS_TOL and FIRST_STAGE_GRAD_TOL;
   step times, peak memory, the save on exit;
24. [1.4B]: `--base sd_tpu_torch/configs/txt2img-1p4B.yaml -t` in process
   with learn_logvar, scale_by_std and scale_factor 1 by dotlist: the 872M
   UNet and the 543M BERTEmbedder trained at batch 4, 256², 3 steps; the
   calibrated scale_factor recomputed from the first batch's draw; every
   step a finite loss, a finite non-zero gradient on every trained tensor
   and exactly K1 = 16 + 16 + 32 + 1, K2 = 32 and K3 = 5; every BERT tensor
   and the logvar table moved; one metrics.jsonl row a step (a finite
   loss and a positive it/s) and one TensorBoard event file under tb/ in
   the run's directory; step times, peak memory, the save on exit;
25. [inpaint]: inpainting_big (sd_tpu_torch/configs/inpainting_big.yaml:
   the VQ-f4 first stage without attention as the cond stage, a 387M UNet
   with legacy attention of 8 heads, resblock up/down, concat) at full
   width with seeded random bf16 weights, built as
   `python -m sd_tpu_torch.scripts.inpaint` builds it; one synthetic 512²
   image with a square mask, DDIM 50, batch 1, through InpaintPipeline:
   encode, sample and decode seconds, exactly K1 = 16 x 50 (its VQ stage
   has no attention), the pixels outside the mask equal to the input's,
   and the sampled latents within relative L2 AGREEMENT_TOL of the same
   request with K1 replaced by its plain version;
26. [sample_diffusion]: `python -m sd_tpu_torch.scripts.sample_diffusion -c
   sd_tpu_torch/configs/celebahq-ldm-vq-4.yaml` through its main() (the
   unconditional CelebA-HQ LDM, 274M UNet with 32-channel heads, VQ-f4 with
   a mid-block attention) at batch 4, 256², DDIM 50 at eta 1, writing its
   .npz to a temporary directory: samples/s, exactly K1 = 16 x 50 + 1, the
   latents within AGREEMENT_TOL of a second build sampling with the plain
   attention, and the share of the card's code indices (fp32 distances)
   that the CPU's fp32 quantizer gives on the same latents;
27. [cin256]: `python -m sd_tpu_torch.scripts.sample_diffusion -c
   sd_tpu_torch/configs/cin256-v2.yaml --classes 25,187,448,992 --scale 3.0
   --custom_steps 20 -e 0` through its main() (the class-conditional
   ImageNet LDM, a 401M UNet with one head at d = 384, 576 and 960 and a
   ClassEmbedder of 1001 classes, guidance against class 1000; VQ-f4) at
   batch 4, 256², as the reference's latent_imagenet_diffusion notebook
   samples: samples/s, exactly K1 = 16 x 20 + 1 (5 sites at d = 384, 5
   at d = 576 and 6 at d = 960, N = 64, a UNet evaluation: the d = 960
   sites, which sd_tpu leaves to XLA, take K1's split plan) and K2 = 16 x
   20, the
   latents within AGREEMENT_TOL of a second build sampling with the plain
   attention, and the share of equal code indices against the CPU;
28. [superres]: bsr_sr (sd_tpu_torch/configs/bsr_sr.yaml: a 114M concat
   UNet with 32-channel heads, VQ-f4, the LR image as the condition) at
   full width: (a) SuperResPipeline upsamples a synthetic 64² image to 256²
   in 9 tiles of 32² (one batch), DDIM 100 at eta 1, as the reference's
   notebook runs it: exactly K1 = 6 x 100 + 1; (b) the LDM's
   split_input_params at the notebook's setting (ks 128, stride 64, vqf 4,
   patch_distributed_vq) on a 256² LR image, DDIM 20 at eta 1: 9 UNet
   patches a step in one call and 225 decode patches in one call, exactly
   K1 = 6 x 20 + 1; each run's seconds, and its latents within
   AGREEMENT_TOL of the same run with the plain attention;
29. [knn2img]: train_searcher's main() pools 4 seeded parts of 4096 x 768
   CLIP-like embeddings into a normalized index; a Searcher on the card over
   a seeded 2^20 x 768 fp32 database (3.2 GB) gives the top 4 of 8 queries
   equal to a float64 top-k on the host (near-ties within SEARCH_TIE may
   trade places), its scores within SEARCH_SCORE_TOL, and its ms; then
   `python -m sd_tpu_torch.scripts.knn2img --config
   sd_tpu_torch/configs/retrieval-augmented-diffusion-768x768.yaml
   --n_samples 4 --ddim_steps 20 --scale 5.0 --knn 4 --use_neighbors`
   through its main() over that index (the 768² RDM, a UNet of
   14 to 56 heads of 32, the kl-f16 first stage, the ViT-L/14 text tower
   with its projection, all seeded): samples/s, four 768² PNGs, exactly
   K1 = 16 x 20 + 4 (the decoder's four d = 512 sites) and K2 = 16 x 20,
   and the latents within AGREEMENT_TOL of a second build sampling with
   the plain K1 and K2;
30. [vae extras]: MergedRescaleEncoder, MergedRescaleDecoder (z_channels
   128) and TimestepVAEModel (a timestep and a 3-channel context) at ch
   128, ch_mult (1, 2, 4, 8), batch 4, 256², seeded, bf16: exactly K1 = 2,
   2 and 1 at [4, 1024, 1, 1024] (K1's split plan), each output within
   AGREEMENT_TOL of itself with the plain attention; TimestepVAEModel again
   with SD_TPU_FUSED_CONV=1: exactly K7 = 2 x 17 (the timestep term in the
   second GroupNorm's offset) and K1 = 1, within AGREEMENT_TOL of its
   unfused output;
31. [data] and [native loader]: seeded JPEGs in a temporary directory (an
   LSUN txt_file over 48 256² images; an ImageNet flat root of 64 images in
   4 synset folders with filelist.txt; an HR-index pickle), removed whether
   the phases pass or fail; NativeImageLoader.load_batch over the LSUN
   files against LSUNBedroomsTrain's own decode (max abs difference within
   1e-6), or, where g++ cannot build against libjpeg and libpng on the
   machine, a line saying so and nothing run;
32. [vq first stage]: `python -m sd_tpu_torch.scripts.train --base
   sd_tpu_torch/configs/vq-f4.yaml -t --no_images` in process over the ImageNet tree
   (data_root by dotlist): the VQ-f4 VQ-GAN with VQLPIPSWithDiscriminator
   at the file's batch of 8, 256², 3 steps through Trainer.fit; every step
   finite logs (perplexity and cluster usage among them) and exactly K1 = 4
   and K3 = 2 at [8, 4096, 1, 512]; step 1's rec, nll, codebook, generator
   and discriminator losses against a second build of the same seed with
   the plain attention, each within its bound (VQ_GAN_COMPARED); the
   card's code indices of a batch's latents against the CPU's fp32
   quantizer;
33. [ldm train uncond] and [ldm train concat]: `--base
   sd_tpu_torch/configs/lsun_bedrooms-ldm-vq-4.yaml -t` over the LSUN tree
   (conditioning_key None, the 274M UNet, batch 48, 256²) and `--base
   sd_tpu_torch/configs/bsr_sr.yaml -t` over ImageNetSRTrain pairs of the
   ImageNet tree (concat, bsrgan_light, 256² to 64², the HR-index pickle,
   batch 64), 3 steps each; exactly K1 = 17 and K3 = 5 (LSUN), K1 = 7
   (bsr_sr) per step; the LSUN model's first loss against the plain
   attention's within FIRST_STAGE_LOSS_TOL; each dataset's host ms per
   batch beside the step's;
34. [classifier]: NoisyLatentClassifierTrainer, its EncoderUNetModel
   derived from the LSUN LDM's UNet params (in_channels 3, 1000 classes,
   pool attention), over VQ-f4 latents of the ImageNet tree at batch 16,
   3 steps: exactly K1 = 9 and K3 = 2 per step; then one
   classifier_guidance_corrector call at t = 500 (K1 = 8, K3 = 2), its
   shifted eps finite and moved;
35. [parallel nccl]: `python -m torch.distributed.run --standalone
   --nproc_per_node 1 -m sd_tpu_torch.scripts.dryrun_multigpu --backend
   nccl --legs train`: SD v1 at full width trained under DDP with ZeRO-1
   (AdamW's moments and the EMA shadow partitioned) at batch 4, 3 steps,
   exactly K1 = 33, K2 = 32 and K3 = 10 a step, then the same 3 steps in
   one process without DDP, AdamW's first moments and the parameters'
   deltas within the dry run's CARD_MOMENT_TOL and CARD_DELTA_TOL
   (relative L2); the ms a step with and without DDP and the peak memory;
   then its first_stage leg: the kl-f8 VAE-GAN (global batch 12) and the
   VQ-f4 VQ-GAN (8) at 256², disc_start 0, 3 steps under DDP, exactly
   K1 = 4 and K3 = 2 a step, against the same steps in one process: every
   gap 0 (both Adams' first moments and deltas, the weights, the logvar,
   the discriminator's running statistics); the ms a step with and
   without DDP, the peak memory;
36. [parallel 2 ranks, one card]: the same module on 2 ranks with
   --backend gloo (NCCL refuses two ranks on one card; gloo's times are no
   speed figure): (a) 2 DDP + ZeRO-1 steps at 2 a rank against one process
   at batch 4 (the same launches a step on each rank; the first moments
   and the deltas within CARD_MOMENT_TOL and CARD_DELTA_TOL); (b) sharded_sample at PLMS 50, guidance 7.5,
   a batch of 8 against one process's batch of 8 from the same x_T
   (relative L2 of the latents within 0.10; K1 = K2 = 16 x 51 a rank);
   (c) one tensor-parallel UNet evaluation at B=2 against the replicated
   one (relative L2 within the dry run's CARD_TP_TOL, 5e-2; one all-reduce a
   row-parallel boundary; a rank's K1 = K2 = 16, the replicated counts);
   (d) a line naming FSDP's collectives that gloo does not take on CUDA
   tensors (HSDP runs on the CPU, in the tests); (e) the first_stage leg
   at 6 and 4 images a rank, 2 steps, DDP + ZeRO-1 over both Adams, each
   rank K1 = 4 and K3 = 2 a step (its mid-blocks at [6, 1024, 1, 512] and
   [4, 4096, 1, 512]), against the one-process reference of 2 ranks (each
   rank's d_weight and batch statistics its own) within CARD_MOMENT_TOL and
   CARD_DELTA_TOL, the running statistics within CARD_MOMENT_TOL, every
   rank's logvar equal. K1 and K2 at a rank's TP shapes
   (4 heads of 40, 80 and 160; inner 640, 1280 and 2560, at B=2 and B=16)
   are checked and timed with the other shapes in phases 3-4;
37. [convergence]: `python -m sd_tpu_torch.scripts.convergence_run` through
   its main() at CONVERGENCE_STEPS (a cut of the JAX tool's 2250, stated on
   a line first) on configs/sd_tpu/convergence-shapes.yaml at full width
   (32², batch 8), its runs in processes of their own on the card: run A
   uninterrupted, run B sent SIGUSR1 past half the steps, SIGKILLed and
   resumed; a smoothed loss reduction above 50%, a difference of exactly 0
   in the UNet's weights, the EMA shadow and the optimizer state, and the
   resumed run's last losses equal to run A's; each run's launches, from
   the line the training CLI prints (the killed run's are not counted),
   exactly K1 = K2 = 4 a step and 4 x 20 an image log; then
   `int8_quality` on run A (the 1000-step clipped ancestral chain at 2
   samples a class, bf16 and int8 "all", of which only the conv engages at
   the probe's widths): the arms differ, PSNR and the colour metrics
   printed, its gate passed (PSNR >= 30 dB, the int8 arm's colour error
   within 0.05 of bf16's), K1 = K2 = 2 x 1000 x 4 and 17 x 1000 int8
   convs; then `int8_quality --flagship` at
   FLAGSHIP_STEPS: SD v1's UNet at 2 samples with guidance, relative L2
   within AGREEMENT_TOL, exactly FLAGSHIP_LAUNCHES. K1 and K2 at the probes'
   shapes (CONVERGENCE_FLASH_SHAPES, _FF_SHAPES, both probes) are checked
   and timed in phases 3-4, K4 and K5 at the flagship's
   (FLAGSHIP_INT8_FF_SHAPES, _FLASH_SHAPES) in phase 10, untimed.

The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. Without CUDA it fails before printing either.
"""

import contextlib
import copy
import gc
import gzip
import importlib
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

STEPS = 50
REQUESTS = 3
TRAIN_STEPS = 5
PROMPT = "a painting of a virus monster playing guitar"
NEGATIVE = "blurry, low quality"
SITES_PER_UNET = 16  # SpatialTransformer blocks of the SD v1 UNet
DPM_STEPS = 20
# UNet evaluations per request of each sampler at S steps: PLMS S + 1 (its
# bootstrap step calls twice), DDIM S, DPM-Solver++ 2M S (one at t_T, one at
# t_1, one a step up to S - 1, none after the last update)
EVALS = {"plms": lambda s: s + 1, "ddim": lambda s: s, "dpm": lambda s: s}
# the self-attention layers of the safety checker's towers: one K1 launch each
UNTRAINED_LAYERS, VIT_L_LAYERS = 2, 24

# (B, N, H, D): the UNet's self-attention sites at 64x64, 32x32, 16x16 and
# 8x8 latents, and the VAE mid-block: serving at batch 1 with guidance (B=2;
# the decoder's mid-block at B=1), then training at batch 4 (the encoder's),
# then serving at batch 8 (B=16; the decoder's at B=8)
FLASH_SHAPES = [(2, 4096, 8, 40), (2, 1024, 8, 80), (2, 256, 8, 160), (2, 64, 8, 160),
                (1, 4096, 1, 512),
                (4, 4096, 8, 40), (4, 1024, 8, 80), (4, 256, 8, 160), (4, 64, 8, 160),
                (4, 4096, 1, 512),
                (16, 4096, 8, 40), (16, 1024, 8, 80), (16, 256, 8, 160), (16, 64, 8, 160),
                (8, 4096, 1, 512)]
# (B, N, H, D): the legacy attention blocks of the VQ-f4 models at full width:
# inpainting_big at 512² (128² latents, 8 heads; batch 1, no guidance) at
# 64², 32² and 16², d = 64, 96 and 128; CelebA-HQ at batch 4 (64² latents,
# heads of 32) at 32², 16² and 8², 14, 21 and 28 heads; its VQ decoder's
# mid-block at batch 4
VQ_FLASH_SHAPES = [(1, 4096, 8, 64), (1, 1024, 8, 96), (1, 256, 8, 128), (4, 1024, 14, 32),
                   (4, 256, 21, 32), (4, 64, 28, 32), (4, 4096, 1, 512)]
# (B, N, H, D): cin256-v2 at batch 4 with guidance (B=8): its one-head sites
# at 32² (d = 384), 16² (d = 576, K1's wide<576> plan) and 8² (d = 960, K1's
# split plan); bsr_sr's 8x level
# (20 heads of 32) and its VQ decoder's mid-block: SuperResPipeline's 9 tiles
# of 32² latents, then the tiled LDM's 9 patches of 128² latents and its 225
# decode patches of 32² latents
WIDE_FLASH_SHAPES = [(8, 1024, 1, 384), (8, 256, 1, 576), (8, 64, 1, 960), (9, 16, 20, 32),
                     (9, 1024, 1, 512), (9, 256, 20, 32), (225, 1024, 1, 512)]
# (B, N, H, D): K1's split plan (576 < d <= 1024) at the first-stage extras'
# one-head sites: batch 4 of 256² images at ch 128, ch_mult (1, 2, 4, 8) puts
# N = 1024 at d = 1024; d = 640 and 768 at that N and at N = 4096
SPLIT_FLASH_SHAPES = [(4, 1024, 1, 640), (4, 1024, 1, 768), (4, 1024, 1, 1024),
                      (1, 4096, 1, 640), (1, 4096, 1, 768), (1, 4096, 1, 1024)]
# (B, N, H, D): the retrieval-augmented 768² RDM with guidance at 4 samples
# (B=8): its self-attention at 48², 24², 12² and 6² latents (14, 28, 42 and
# 56 heads of 32; N = 144 and 36 are not multiples of 128 and take K1 all
# the same), and its kl-f16 decoder's four sites at 48² (d = 512) at batch 4
RDM_FLASH_SHAPES = [(8, 2304, 14, 32), (8, 576, 28, 32), (8, 144, 42, 32), (8, 36, 56, 32),
                    (4, 2304, 1, 512)]
# (M, C, inner): the RDM's FF sites at those levels, M = 8 x N: C = 1792
# with inner 7168 is wider than any SD v1 FF
RDM_FF_SHAPES = [(18432, 448, 1792), (4608, 896, 3584), (1152, 1344, 5376), (288, 1792, 7168)]
# SD v1 tensor-parallel over 2 ranks (parallel/tp.py): a rank's K1 runs 4
# heads of 40, 80 and 160, and its K2 an inner width of 640, 1280 and 2560,
# at batch 1 with guidance (B=2) and batch 8 (B=16)
TP_FLASH_SHAPES = [(2, 4096, 4, 40), (2, 1024, 4, 80), (2, 256, 4, 160), (2, 64, 4, 160),
                   (16, 4096, 4, 40), (16, 1024, 4, 80), (16, 256, 4, 160), (16, 64, 4, 160)]
TP_FF_SHAPES = [(8192, 320, 640), (2048, 640, 1280), (512, 1280, 2560), (128, 1280, 2560),
                (65536, 320, 640), (16384, 640, 1280), (4096, 1280, 2560), (1024, 1280, 2560)]
# (B, N, H, D): the safety checker's vision tower, the untrained one (7x7
# patches of 32 and the class token, width 64, 4 heads) and ViT-L/14 (16x16
# patches of 14 and the class token, 16 heads of 64), at batch 1 and 8: a new
# head dim (16), a ragged key count (50) and N=257 at 16 heads
SAFETY_FLASH_SHAPES = [(1, 50, 4, 16), (8, 50, 4, 16), (1, 257, 16, 64), (8, 257, 16, 64)]
# (M, C, inner): the transformer FF blocks, M = B * tokens: serving at batch 1
# (B=2), training at batch 4, serving at batch 8 (B=16; its 8x8 site,
# M=1024, is training's 16x16 one), and one ragged shape (M not a multiple
# of any block's rows)
FF_SHAPES = [(8192, 320, 1280), (2048, 640, 2560), (512, 1280, 5120), (128, 1280, 5120),
             (16384, 320, 1280), (4096, 640, 2560), (1024, 1280, 5120), (256, 1280, 5120),
             (65536, 320, 1280), (16384, 640, 2560), (4096, 1280, 5120), (1000, 320, 1280)]
# (B, N, H, D): the training sites that take K3 (N > 256) at batch 4
BWD_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80)]
# (B, N, H, D): the first stage's mid-blocks in VAE-GAN training (encoder and
# decoder alike), K3's wide plan: 256² at the config's batch of 12, and 512²
VAE_BWD_SHAPES = [(12, 1024, 1, 512), (2, 4096, 1, 512)]
# (B, N, H, D): a rank's mid-blocks in the first_stage leg at two ranks: the
# kl-f8 VAE-GAN at 12 / 2 images of 256², the VQ-f4 VQ-GAN at 8 / 2 (K1's
# [4, 4096, 1, 512] is in FLASH_SHAPES too; at one rank both models' shapes
# are VAE_BWD_SHAPES' and TRAIN_VQ_BWD_SHAPES')
DP_VAE_BWD_SHAPES = [(6, 1024, 1, 512), (4, 4096, 1, 512)]
# the 1.4B LDM's training at batch 4, 256² (32x32 latents), where the lists
# above do not hold its shapes. (B, N, H, D) of K1 (with the lse autograd
# asks for): the UNet's self-attention at 32x32 and 16x16 (its 8x8 site is
# FLASH_SHAPES' (4, 64, 8, 160)), BERT's 32 layers (77 tokens, 8 heads of 64;
# their backward is the plain one) and the frozen encoder's mid-block
LDM_1P4B_FLASH_SHAPES = [(4, 1024, 8, 40), (4, 256, 8, 80), (4, 77, 8, 64), (4, 1024, 1, 512)]
# (B, N, H, D) of K3: its five N=1024 sites
LDM_1P4B_BWD_SHAPES = [(4, 1024, 8, 40)]
# (M, C, inner) of K2: the FF sites at 32x32 and 16x16 (its 8x8 site is
# FF_SHAPES' (256, 1280, 5120))
LDM_1P4B_FF_SHAPES = [(4096, 320, 1280), (1024, 640, 2560)]
# (B, N, H, D): the training paths of the VQ-f4 models at their files'
# batches (the VQ-GAN's mid-blocks at 8 images are FLASH_SHAPES' (8, 4096,
# 1, 512)): the frozen VQ-f4 encoder's mid-block at the LSUN LDM's 48,
# bsr_sr's 64 and the classifier's 16; the LSUN-bedrooms UNet's legacy
# blocks at 48 (32², 16², 8²: 14, 21 and 28 heads of 32), bsr_sr's 8x level
# at 64 (20 heads of 32); the classifier's trunk at 16 (the UNet's blocks)
# and its AttentionPool2d (8² + 1 tokens, 28 heads of 32)
TRAIN_VQ_FLASH_SHAPES = [(48, 4096, 1, 512), (48, 1024, 14, 32),
                         (48, 256, 21, 32), (48, 64, 28, 32), (64, 4096, 1, 512),
                         (64, 64, 20, 32), (16, 4096, 1, 512), (16, 1024, 14, 32),
                         (16, 256, 21, 32), (16, 64, 28, 32), (16, 65, 28, 32)]
# (B, N, H, D) of K3 there: the VQ-GAN's mid-blocks, the N=1024 sites of the
# LSUN LDM and of the classifier (N <= 256 takes the plain backward)
TRAIN_VQ_BWD_SHAPES = [(8, 4096, 1, 512), (48, 1024, 14, 32), (16, 1024, 14, 32)]
# (B, N, H, D): the ColoredShapes probes' self-attention (4 heads at the 16²
# level of their 32² images; d = 16 in convergence-shapes.yaml, 32 in -v2):
# training at batch 8 (with the lse autograd asks for; N = 256 takes the
# plain backward), the image logger's DDIM at 4, int8_quality's ancestral
# chain at 16
CONVERGENCE_FLASH_SHAPES = [(b, 256, 4, d) for d in (16, 32) for b in (8, 4, 16)]
# (M, C, inner): the probes' FF sites at those batches, M = B x 256 (C = 64,
# inner 256; C = 128, inner 512 in -v2)
CONVERGENCE_FF_SHAPES = [(b * 256, c, 4 * c) for c in (64, 128) for b in (8, 4, 16)]
# bf16 rounds to 8 mantissa bits (2^-9 relative) at P or h, at dS and at the
# outputs; the error bound is 2e-2 of the output's scale: max |plain| for K1
# and K3, whose outputs are well below 1, and max(1, max |plain|) for K2
KERNEL_TOL = 2e-2
# K1's log-sum-exp is fp32 throughout: absolute bound in log2 units
LSE_TOL = 1e-3
# every K1 and K3 shape runs a second time with q scaled by this, so that
# the logits (std about 4) pick out a few keys: near-uniform logits hardly
# move the running max and can hide a wrong rescale of O
SHARP = 4.0
# the fp32 model on the card (SD_TPU_PRECISION=fp32, TF32 off for matmul and
# cuDNN) against fp32 on the CPU, the same ops summed in other orders, for
# each of: max |diff| / max |ref| of the tiny model's latents after 6 UNet
# calls with guidance 7.5 (the CPU's fp32 run reads 2.5e-6 against its fp64
# run; the card's bf16 run about 1e-2), a training loss (relative) and its
# UNet gradients (relative L2)
FP32_TOL = 1e-3
# tiny model, bf16 on the card vs fp32 on the CPU after 6 UNet calls with
# guidance 7.5 (PLMS 5; DDIM at eta 0 and 1 and DPM-Solver++ at orders 2 and 3
# make 5): max |diff| of the latents over max |fp32 latents|
REFERENCE_TOL = 5e-2
# val/loss_simple_ema against the EMA shadow's loss recomputed from the same
# draws with the same kernels (relative): a repeat, so only a reduction's
# order may differ. The check logs the current weights' loss beside it: a
# mix of the two weights lies between them
EMA_VAL_TOL = 1e-5
# the untrained safety checker's image embeddings, its tower in bf16 on the
# card vs fp32 on the CPU from the same uint8 images: max |diff| / max |ref|.
# Two layers and the projection, each rounding to bf16 (2^-9 relative) at its
# outputs: about 1e-2 expected
SAFETY_EMBED_TOL = 5e-2
# tiny training step, bf16 autocast on the card vs fp32 on the CPU: the loss
# (relative), all UNet gradients together (relative L2), and each tensor's
# gradient: |diff| <= 0.25 |ref| + 1e-4 |all ref| (L2 norms), so a tensor that
# gets no gradient on the card fails unless its reference gradient is itself
# negligible. The tiny UNet's GroupNorm groups hold one channel each at its
# first level, which cancels the per-channel timestep shift there: those
# emb_layers have a zero gradient in exact arithmetic and only rounding noise
# on either device.
TRAIN_LOSS_TOL = 2e-2
TRAIN_GRAD_TOL = 5e-2
TRAIN_TENSOR_TOL = 0.25
TRAIN_TENSOR_FLOOR = 1e-4
# per training step of SD v1 with use_checkpoint: 16 UNet sites forward, the
# same 16 again when checkpointing recomputes them in the backward, and the
# VAE encoder's mid-block; K3 at the five N=4096 and five N=1024 sites
TRAIN_LAUNCHES = {"flash_attention": 2 * SITES_PER_UNET + 1, "geglu_ff": 2 * SITES_PER_UNET,
                  "flash_attention_bwd": 10}
# the VQ-f4 models' phases: inpainting_big at 512², batch 1, and CelebA-HQ at
# 256², batch 4, DDIM 50 each; K1 at 16 sites a UNet evaluation, and at
# CelebA-HQ's VQ decoder's mid-block once (inpainting_big's VQ stage has none)
INPAINT_CONFIG = "sd_tpu_torch/configs/inpainting_big.yaml"
CELEBAHQ_CONFIG = "sd_tpu_torch/configs/celebahq-ldm-vq-4.yaml"
CELEBAHQ_BATCH = 4
# cin256-v2 at the reference notebook's settings (latent_imagenet_diffusion:
# four classes, guidance 3.0 against class 1000, DDIM 20 at eta 0), batch 4,
# 256²: K1 at its 5 d = 384, 5 d = 576 and 6 d = 960 sites a UNet evaluation (one
# evaluation a step, guidance batched) and the VQ decoder's mid-block; K2 at
# its 16 transformer blocks
CIN256_CONFIG = "sd_tpu_torch/configs/cin256-v2.yaml"
CIN256_ARGS = ["--classes", "25,187,448,992", "--scale", "3.0", "--custom_steps", "20",
               "-e", "0", "-n", "4", "--batch_size", "4"]
CIN256_STEPS = 20
CIN256_K1_SITES, CIN256_K2_SITES = 16, 16
# bsr_sr: (a) SuperResPipeline on a 64² LR image to 256², 9 tiles, DDIM 100
# at eta 1 (the notebook's); (b) split_input_params at the notebook's
# setting on a 256² LR image, DDIM 20 at eta 1; K1 at the UNet's 6 attention
# blocks (8x level and middle block) a step and once at the decode
SR_CONFIG = "sd_tpu_torch/configs/bsr_sr.yaml"
SR_STEPS, SR_SPLIT_STEPS = 100, 20
SR_K1_SITES = 6
SR_SPLIT_PARAMS = {"ks": (128, 128), "stride": (64, 64), "vqf": 4, "patch_distributed_vq": True,
                   "clip_max_weight": 0.5, "clip_min_weight": 0.01}
# the retrieval-augmented 768² RDM through knn2img's main(): 4 samples with
# guidance 5.0 (one UNet evaluation of B=8 a step), DDIM 20 at eta 0, the
# query and its 4 nearest neighbours as the context (5 keys: its
# cross-attention takes the plain route); K1 and K2 at the UNet's 16
# transformer sites a step, K1 at the kl-f16 decoder's 4 sites (d = 512)
RDM_CONFIG = "sd_tpu_torch/configs/retrieval-augmented-diffusion-768x768.yaml"
RDM_SAMPLES, RDM_STEPS, RDM_KNN, RDM_SCALE = 4, 20, 4, 5.0
RDM_K1_SITES, RDM_K2_SITES, RDM_DECODER_SITES = 16, 16, 4
# train_searcher's seeded CLIP-embedding parts (parts x rows x 768), and the
# Searcher's database on the card: 2^20 x 768 fp32 (3.2 GB), top-4 of 8
# queries against a float64 top-k on the host; two neighbours whose float64
# scores lie within SEARCH_TIE of each other may trade places
INDEX_PARTS, INDEX_ROWS = 4, 4096
SEARCH_ROWS, SEARCH_QUERIES, SEARCH_K = 2**20, 8, 4
SEARCH_TIE = 1e-5
SEARCH_SCORE_TOL = 1e-5
# the first-stage extras at ch 128, ch_mult (1, 2, 4, 8), batch 4 of 256²
# images (32² at the lowest level): MergedRescaleEncoder (the encoder's
# mid-block and its rescaler's attention, d = 1024), MergedRescaleDecoder
# (z_channels 128: its rescaler's and its decoder's mid-block, d = 1024) and
# TimestepVAEModel (its mid-block, with a timestep and a 3-channel context);
# K1 launches per call. In the fused-conv mode 17 of TimestepVAEModel's 22
# resnet blocks pass K7's gate (sd_tpu's, at bf16: the five up blocks whose
# concatenated input is 2048, 2048, 1536, 768 and 384 channels at its
# level's first block, or 2048 at 32², fail it), two launches each
EXTRAS_BATCH = 4
EXTRAS_K1 = {"MergedRescaleEncoder": 2, "MergedRescaleDecoder": 2, "TimestepVAEModel": 1}
TIMESTEP_FUSED_BLOCKS = 17
# (B, C, H=W, N, launch) of those fused blocks' K7 launches
TIMESTEP_FUSED_SHAPES = (
    [(4, c, hw, n, "first") for c, hw, n in (
        (128, 256, 128), (256, 256, 128), (128, 128, 256), (256, 128, 256), (512, 128, 256),
        (384, 128, 256), (256, 64, 512), (512, 64, 512), (1024, 64, 512), (768, 64, 512),
        (512, 32, 1024), (1024, 32, 1024), (1536, 32, 1024))]
    + [(4, n, hw, n, "second") for hw, n in ((256, 128), (128, 256), (64, 512), (32, 1024))])
# the card's code indices against the CPU's fp32 quantizer on the same latents:
# both compute the distances in fp32, so only the order of a sum differs
CODE_AGREEMENT_MIN = 0.99
# the two --base training phases: the kl-f8 VAE-GAN at batch 12, 256²
# (autoencoder_kl_32x32x4.yaml, the discriminator engaged from step 2 by
# disc_start=1), and the LAION 1.4B LDM with its 32-layer BERT trained, at
# batch 4, 256² (txt2img-1p4B.yaml, with learn_logvar and scale_by_std)
FIRST_STAGE_CONFIG = "sd_tpu_torch/configs/autoencoder_kl_32x32x4.yaml"
LDM_1P4B_CONFIG = "sd_tpu_torch/configs/txt2img-1p4B.yaml"
FIRST_STAGE_STEPS = 3
LDM_1P4B_STEPS = 3
# per VAE-GAN step: the generator step's forward (the encoder's and the
# decoder's mid-blocks, K1 with lse) and backward (K3 at both), then the
# discriminator step's reconstruction without a gradient (K1 at both)
FIRST_STAGE_LAUNCHES = {"flash_attention": 4, "flash_attention_bwd": 2}
BERT_LAYERS = 32
# per 1.4B LDM step: the UNet's 16 sites forward and again in the
# checkpointed backward, BERT's 32 self-attentions (N=77: K1 forward, the
# plain backward), the VAE encoder's mid-block; K3 at the five N=1024 sites
# (32x32 latents); K2 at the 16 FF sites twice
LDM_1P4B_LAUNCHES = {"flash_attention": 2 * SITES_PER_UNET + BERT_LAYERS + 1,
                     "geglu_ff": 2 * SITES_PER_UNET, "flash_attention_bwd": 5}
# the VAE-GAN's first two steps with K1 and K3 against the same steps with
# the plain attention (fp32 softmax, autograd through plain torch ops), both
# in bf16 autocast from the same weights, batch and posterior noise (the
# discriminator step's reconstruction, without a gradient, takes K1 in
# both). Compared: each step's losses but d_weight, which both clip to
# 1e4 x disc_weight, relative; step 1's gradients, relative L2, of the
# q, k and v convs of each mid-block's attention (K3's dQ, dK and dV through
# a 1x1 conv) and of the whole encoder, which the loss reaches through both
# mid-blocks. Step 2's losses follow one Adam step (about lr x sign(g)), so
# the gradients are what K3 decides. The bounds are set from the readings
# of `python -m sd_tpu_torch.scripts.flash_faults --first-stage` on an H100:
# the sound sources read at most 3.5e-4 (losses) and 6.1e-3 (gradients);
# each of the six K1 and K3 faults reads 0.11 or more (or a non-finite
# value) on some gradient group, and five of them 5.2e-3 or more (or a
# non-finite value) on a loss; K3's wide plan's dropped tile, at most
# 4.9e-4 on the losses, shows in the gradients only
FIRST_STAGE_COMPARED = ("rec_loss", "nll_loss", "kl_loss", "g_loss", "disc_loss")
FIRST_STAGE_GRAD_GROUPS = tuple(f"{part}.mid.attn_1.{w}" for part in ("encoder", "decoder")
                                for w in "qkv") + ("encoder",)
FIRST_STAGE_LOSS_TOL = 2e-3
FIRST_STAGE_GRAD_TOL = 2e-2
# the training paths of the VQ-f4 models, 3 steps each through their entry
# points, over synthetic trees of seeded JPEGs: the VQ-f4 VQ-GAN through
# --base vq-f4.yaml at its batch of 8, 256², on ImageNet; the LSUN-bedrooms
# LDM (conditioning_key None) through --base at its batch of 48 on LSUN;
# bsr_sr (concat) through --base at its batch of 64 on ImageNet-SR pairs
# (bsrgan_light, 256² to 64², an HR-index pickle); the noisy-latent
# classifier (the library trainer: sd_tpu gives it no CLI) at batch 16 over
# VQ-f4 latents of the ImageNet tree, 1000 classes
VQ_CONFIG = "sd_tpu_torch/configs/vq-f4.yaml"
LSUN_CONFIG = "sd_tpu_torch/configs/lsun_bedrooms-ldm-vq-4.yaml"
DATA_STEPS = 3
LSUN_IMAGES, IMAGENET_IMAGES = 48, 64
CLASSIFIER_BATCH, IMAGENET_CLASSES = 16, 1000
# per VQ-GAN step, as per kl-f8 VAE-GAN step (FIRST_STAGE_LAUNCHES): both
# mid-blocks in the generator's forward and in the discriminator step's
# reconstruction, K3 at both
VQ_GAN_LAUNCHES = FIRST_STAGE_LAUNCHES
# per LSUN LDM step: the UNet's 16 legacy blocks (no use_checkpoint) and the
# frozen encoder's mid-block; K3 at the five N=1024 sites
LSUN_LAUNCHES = {"flash_attention": 17, "flash_attention_bwd": 5}
# per bsr_sr step: its 6 blocks at 8x8 (N=64: the plain backward) and the
# frozen encoder's mid-block
SR_TRAIN_LAUNCHES = {"flash_attention": SR_K1_SITES + 1}
# per classifier step: its 7 legacy blocks, AttentionPool2d, the frozen
# encoder's mid-block; K3 at the two N=1024 sites. One guidance call: the
# classifier's 8 sites forward, K3 at the two in the gradient
CLASSIFIER_LAUNCHES = {"flash_attention": 9, "flash_attention_bwd": 2}
CORRECTOR_LAUNCHES = {"flash_attention": 8, "flash_attention_bwd": 2}
# the VQ-GAN's first step with K1 and K3 against the same step with the
# plain attention from the same weights and batch, and the LSUN LDM's first
# loss likewise, relative: FIRST_STAGE_LOSS_TOL (the kl-f8 VAE-GAN's bound,
# whose sound runs read at most 3.5e-4; not re-derived with planted faults
# on these models) for the losses the codes pass into smoothly, and
# VQ_GAN_DISC_TOL for the discriminator's two. The quantizer turns the
# attention's bf16 rounding into a few other codes (874 against 869 codes in
# use at step 1 of a probe run on an H100), whose reconstructed pixels move
# the PatchGAN's mean logit: the probe read 4.6e-5 (rec_loss), 3.7e-4
# (quant_loss), 7.7e-3 (g_loss) and 1.3e-2 (disc_loss, after the
# generator's update)
VQ_GAN_COMPARED = {"rec_loss": FIRST_STAGE_LOSS_TOL, "nll_loss": FIRST_STAGE_LOSS_TOL,
                   "quant_loss": FIRST_STAGE_LOSS_TOL, "g_loss": 5e-2, "disc_loss": 5e-2}
# the H100 SXM's dense bf16 and int8 tensor-core rates and memory rate
PEAK_FLOPS = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12

# the int8 serving path. (M, C, inner): the FF sites K4 takes, batch 1 (B=2)
# then batch 8 (B=16)
INT8_FF_SHAPES = [(2048, 640, 2560), (16384, 640, 2560), (4096, 1280, 5120),
                  (1024, 1280, 5120)]
# (B, N, H, D, mode): the UNet's N=4096 sites and the decoder's mid-block
INT8_FLASH_SHAPES = [(2, 4096, 8, 40, "qk"), (16, 4096, 8, 40, "qk"), (1, 4096, 1, 512, "qk"),
                     (1, 4096, 1, 512, "qkpv"), (8, 4096, 1, 512, "qk")]
# int8_quality --flagship's shapes that serving does not give: SD v1 at 2
# samples with guidance (B=4), K4 at the 32² level (M = 4 x 1024) and K5 at
# the 64² level; checked within INT8_TOL, not timed
FLAGSHIP_INT8_FF_SHAPES = [(4096, 640, 2560)]
FLAGSHIP_INT8_FLASH_SHAPES = [(4, 4096, 8, 40, "qk")]
# K5 "qkpv" at d <= 48 (its narrow kernel), which no serving path takes
# (attn_pv gives "qkpv" at d >= 256 only): checked within INT8_TOL, not timed
INT8_FLASH_OFF_PATH = [(2, 4096, 8, 40, "qkpv")]
# (M, C, F): the proj bucket's self-attention QKV (F = 3C), cross q and
# to_out (F = C), batch 1 then batch 8
INT8_DENSE_SHAPES = [(b * n, c, f * c) for b in (2, 16)
                     for n, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280))
                     for f in (3, 1)]
# the flagship agreement gate of tools/int8_quality.py (the port's
# int8_quality.AGREEMENT_TOL, which [serve int8] and [convergence] apply):
# int8 (or a conv mode) against bf16 latents after the whole trajectory,
# relative L2
AGREEMENT_TOL = 0.10
BATCH8 = 8
# The int8 kernels' max abs error bounds, as fractions of the output's scale
# (max |plain|, at least 1 for K4 and K6), each set between the kernel's
# reading and that of the same inputs through the bf16 path without the
# quantization (K2, K1, F.linear; K5 "qk" for "qkpv"). On an H100 80GB HBM3
# at 700 W the sound kernels read at most 9.2e-3 (K4), 3.3e-3 (K5 "qk"),
# 1.2e-2 (K5 "qkpv") and 3.5e-3 (K6); the bf16 paths at least 3.3e-2,
# 1.3e-2, 1.1e-1 and 1.0e-2. Every run asserts that each bf16 path would
# fail its kernel's bound, so that a kernel that skipped its quantization
# cannot pass; KERNEL_TOL (2e-2) would pass one at K5 "qk"'s shapes.
INT8_TOL = {"K4": 1.6e-2, "K5 qk": 6e-3, "K5 qkpv": 2e-2, "K6": 6e-3}

# K7's launches of the fused serving path: (B, C, H=W, N, launch), "first"
# (prologue + moments) or "second" (prologue + bias + skip), the UNet's
# blocks at B=2, the decoder's at B=1
FUSED_SHAPES = ([(2, c, hw, n, "first") for c, hw, n in (
    (640, 32, 640), (640, 16, 1280), (1280, 16, 1280), (2560, 16, 1280), (1920, 16, 1280),
    (1920, 32, 640), (1280, 32, 640))]
    + [(2, 640, 32, 640, "second"), (2, 1280, 16, 1280, "second")]
    + [(1, c, hw, c, launch) for c, hw in ((512, 64), (512, 128), (256, 256))
       for launch in ("first", "second")])
# K8's sites (B, C, H=W, K): the UNet's at 64² and 32² at B=2, the decoder's
WINO_SHAPES = [(2, 320, 64, 320), (2, 960, 64, 320), (2, 640, 64, 320), (2, 640, 64, 640),
               (2, 320, 32, 640), (2, 640, 32, 640), (2, 1280, 32, 640), (2, 960, 32, 640),
               (2, 1280, 32, 1280), (1, 512, 64, 512), (1, 512, 128, 512), (1, 512, 256, 512),
               (1, 512, 256, 256), (1, 256, 256, 256), (1, 256, 512, 256), (1, 256, 512, 128),
               (1, 128, 512, 128)]
# tools/exp_winograd.py's LEVELS at its B=16: X3's experiment path
X3_LEVELS = [(16, 320, 64, 320), (16, 640, 32, 640), (16, 1280, 16, 1280), (16, 1280, 8, 1280)]
# K8 and X3 off the plans' multiples (B, C, H, W, K): tile grids of 9 x 17
# and 11 x 20, C not a multiple of the channel step, K not of a block's
# channels; W = 34 takes X3's 4-byte copies, W = 40 its 16-byte ones
WINO_RAGGED = [(1, 136, 18, 34, 136), (2, 200, 22, 40, 264)]
# K7's and K8's sites per request of SD v1 (gates of sd_tpu, asserted equal
# on these shapes by tests/test_torch_conv_modes.py): fused blocks (two
# launches each) and Winograd Conv3x3 calls per UNet evaluation and in the
# decoder, alone and beside the fused blocks
FUSED_BLOCKS = {"unet": 8, "decoder": 10}
WINO_SITES = {"unet": 21, "decoder": 31}
WINO_SITES_BESIDE_FUSED = {"unet": 16, "decoder": 11}
# the small UNet with both conv modes, bf16 on the card against fp32 on the
# CPU: max |diff| of the output over max |fp32 output|
CONV_MODES_TOL = 5e-2
# the block experiment (tools/exp_block_kernel.py) at SD v1's four
# transformer sites (N, C), at its B=16 with 8 heads, inner 4C, and 77
# context keys of 128 rows
BLOCK_SITES = [(4096, 320), (1024, 640), (256, 1280), (64, 1280)]
# X2 off every row tile (B, N, C), 77 keys of 128: checked within KERNEL_TOL,
# not timed
X2_OFF_GRID = [(3, 100, 320)]
# X1∘X2 on a port BasicTransformerBlock against the block itself, both bf16
# on the card: relative L2 of the outputs. They round at other points (the
# single-pass LayerNorm variance, P against a per-tile or per-row max,
# bias rounding), each about 2^-9 relative
BLOCK_AGREEMENT_TOL = 1e-2
CONTEXT_DIM = 768  # SD v1's CLIP ViT-L/14 text width
# K7's gradient through the autograd function (bf16 inputs, so bf16
# per-pixel gradients) against the plain backward in fp32: relative L2 of
# each gradient. The per-channel gradients (da, dd, dbias) sum per-pixel
# terms of both signs, whose 2^-9 roundings survive the cancellation: 1.3e-2
# and 1.5e-2 at a small shape on the CPU
FUSED_GRAD_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def check_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script "
                         "runs on the card only")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {name}, {torch.cuda.device_count()} visible; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)
    return name


def build() -> None:
    from sd_tpu_torch.ops.cuda import _build

    info = _build.build_info()
    _build.kernels()
    lines = [line.strip() for line in info["log"].splitlines()]
    used = [line for line in lines if "Used" in line]
    spills = [line for line in lines if "spill" in line and not line.startswith("0 bytes")]
    log(f"[build] {info['path']} in {info['seconds']:.1f} s: {len(used)} kernels, "
        f"{len(spills)} with register spills")
    kernel, seen = None, set()
    for line in lines:
        if "Function properties for" in line:
            kernel = line.rsplit(" ", 1)[-1]
        elif "spill" in line and not line.startswith("0 bytes") and kernel not in seen:
            log(f"[build]   {kernel}: {line}")
        elif "Used" in line and kernel not in seen:
            # K1's, K3's, K5's, K8's, X3's, K2's, K7's, K6's, K4's, X1's and
            # X2's kernels by name and template arguments
            name = re.search(r"flash_(?:fwd|bwd)_[a-z_]*kernel(?:_wide)?|winograd_kernel|"
                             r"int8_attn_kernel(?:_wide)?|geglu_gemm_kernel|"
                             r"fused_conv(?:_reduce)?_kernel|int8_dense_kernel|k4_out_kernel|"
                             r"x1_qkv_kernel|x1_attn_kernel|ln_rows_kernel", kernel or "")
            if name:
                args = ",".join(re.findall(r"L[ib](\d+)E", kernel))
                log(f"[build]   {name.group(0)}<{args}>: {line.split(':', 1)[1].strip()}")
            seen.add(kernel)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, int8_ops: float = 0.0) -> dict:
    """The least time of the work on this card: the bf16 operations over the
    bf16 peak plus the int8 operations over the int8 peak, or the bytes over
    the memory rate, whichever is larger."""
    ops_ms = (flops / PEAK_FLOPS + int8_ops / PEAK_INT8) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


class CheckFailed(AssertionError):
    """A kernel's output outside its bound: ``err`` against ``limit``."""

    def __init__(self, msg: str, err: float, limit: float):
        super().__init__(msg)
        self.err, self.limit = err, limit


def check_error(name: str, shape, got: torch.Tensor, ref: torch.Tensor,
                scale_floor: float = 0.0, tol: float = KERNEL_TOL,
                residual: Optional[torch.Tensor] = None) -> float:
    """max |got − ref| within ``tol`` of the scale: max(scale_floor,
    max |ref|), or with ``residual`` max |ref − residual|, the branch a
    kernel adds to its residual input, so that a fault in a branch much
    smaller than the residual still shows."""
    err = (got.float() - ref).abs().max().item()
    label = "max |plain|" if residual is None else "max |plain - x|"
    ref_max = (ref if residual is None else ref - residual.float()).abs().max().item()
    limit = tol * max(scale_floor, ref_max)
    ok = np.isfinite(err) and err <= limit
    log(f"[{name}] {shape}: max_abs_err {err:.3e} ({label} {ref_max:.3e}, bound "
        f"{limit:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise CheckFailed(f"{name} at {shape}: max abs error {err} above {limit}", err, limit)
    return err


def check_lse(shape, got: torch.Tensor, ref: torch.Tensor) -> float:
    """K1's row log-sum-exp within LSE_TOL (absolute, log2 units)."""
    err = (got - ref).abs().max().item()
    log(f"[K1 flash_attention] {shape}: log-sum-exp max_abs_err {err:.3e} (bound {LSE_TOL})")
    if not (np.isfinite(err) and err <= LSE_TOL):
        raise CheckFailed(f"K1 log-sum-exp at {shape}: {err}", err, LSE_TOL)
    return err


def check_int8_error(name: str, shape, got: torch.Tensor, ref: torch.Tensor, unquantized: dict,
                     scale_floor: float = 0.0) -> float:
    """check_error within INT8_TOL[name], and each output in ``unquantized``
    (label: the same inputs through a path without the quantization) outside
    that bound."""
    tol = INT8_TOL[name]
    err = check_error(name, shape, got, ref, scale_floor, tol)
    scale = max(scale_floor, ref.abs().max().item())
    for label, other in unquantized.items():
        other_err = (other.float() - ref).abs().max().item()
        ok = np.isfinite(other_err) and other_err > tol * scale
        log(f"[{name}] {shape}: max abs error {err / scale:.3e} of the scale (bound {tol}); "
            f"{label} without int8 {other_err / scale:.3e}, "
            f"{'outside the bound, ok' if ok else 'INSIDE THE BOUND, FAIL'}")
        if not ok:
            raise AssertionError(f"{name} at {shape}: {label} without int8 reads {other_err}, "
                                 f"within the bound {tol * scale}: the check cannot tell them "
                                 f"apart")
    return err


def sdpa(q, k, v, scale):
    """The library yardstick on the token-major [B, N, H, D] inputs."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), scale=scale)


def by_batch(fn, *tensors):
    """``fn`` over one batch element at a time, concatenated: the same
    function, for the plain references whose [B, H, N, N] fp32 logits would
    not fit beside the timings."""
    return torch.cat([fn(*(t[i:i + 1] for t in tensors)) for i in range(tensors[0].shape[0])])


def log_plan(which: str, shape) -> None:
    """The launch plan of K1, of a K3 pass or of K5 at ``shape``: its blocks and
    the waves they take on this card."""
    from sd_tpu_torch.ops.cuda.flash_attention import kernel_plan

    b, n, h, d = shape
    plan = kernel_plan(d, which, (b, n, h))
    slices = plan.get("slices", 1)
    blocks = -(-n // plan["rows"]) * h * b * slices
    slots = plan["blocks_per_sm"] * torch.cuda.get_device_properties(0).multi_processor_count
    split = f", O's columns in {slices} slices" if slices > 1 else ""
    log(f"[{which} plan] {shape}: {plan['rows']} rows a block, tiles of {plan['tile']}{split}, "
        f"{plan['threads']} threads, {plan['smem_bytes']} bytes of shared memory, "
        f"{plan['blocks_per_sm']} blocks per SM; {blocks} blocks, {blocks / slots:.2f} waves")


def flash_case(randn, shape, sharp: bool = False, timed: bool = True) -> dict:
    """K1 at one shape against its plain version (output and row
    log-sum-exp); with ``sharp``, q scaled by SHARP. Timed: the kernel, the
    plain version, sdpa and the bound."""
    from sd_tpu_torch.ops.cuda import (flash_attention, flash_attention_lse_plain,
                                       flash_attention_plain)
    from sd_tpu_torch.ops.cuda.flash_attention import _launch_forward

    b, n, h, d = shape
    scale = d**-0.5
    bf = [randn(*shape).to(torch.bfloat16) for _ in range(3)]
    if sharp:
        bf[0] = bf[0] * SHARP
    label = f"{shape}{' sharp' if sharp else ''}"
    out = flash_attention(*bf, scale)
    # the log-sum-exp that only the autograd path asks K1 for
    lse = _launch_forward(*bf, scale, with_lse=True)[1]
    torch.cuda.synchronize()
    fp = [t.float() for t in bf]
    big = b * h * n * n * 4 > 2**31
    plain = lambda *t: flash_attention_plain(*t, scale)
    lse_plain = lambda q, k: flash_attention_lse_plain(q, k, scale)
    ref, lse_ref = ((by_batch(plain, *fp), by_batch(lse_plain, *fp[:2])) if big
                    else (plain(*fp), lse_plain(*fp[:2])))
    err = check_error("K1 flash_attention", label, out, ref)
    check_lse(label, lse, lse_ref)
    del fp
    if not timed:
        return dict(err=err)
    ms = time_ms(lambda: flash_attention(*bf, scale))
    plain_ms = time_ms(lambda: flash_attention_plain(*bf, scale), iters=5 if big else 20)
    library_ms = time_ms(lambda: sdpa(*bf, scale))
    bnd = bound(4 * b * h * n * n * d, 4 * b * n * h * d * 2)
    # the split plan (d > 576) recomputes Q K^T once per slice of O's columns
    slices = -(-d // 256) if d > 576 else 1
    work = f"; the split plan does {(2 * slices + 2) / 4:.2f}x that work" if slices > 1 else ""
    log(f"[K1 flash_attention] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms ({sdpa_backend(*bf, scale)}), bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}){work}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bnd)


def check_flash(randn) -> list:
    groups = {f"the {len(FLASH_SHAPES)} UNet and VAE shapes": FLASH_SHAPES,
              f"the {len(SAFETY_FLASH_SHAPES)} safety-tower shapes": SAFETY_FLASH_SHAPES,
              f"the {len(VQ_FLASH_SHAPES)} VQ-f4 model shapes": VQ_FLASH_SHAPES,
              f"the {len(WIDE_FLASH_SHAPES)} cin256-v2 and super-resolution shapes":
              WIDE_FLASH_SHAPES,
              f"the {len(SPLIT_FLASH_SHAPES)} split-plan shapes": SPLIT_FLASH_SHAPES,
              f"the {len(RDM_FLASH_SHAPES)} RDM shapes": RDM_FLASH_SHAPES,
              f"the {len(TRAIN_VQ_FLASH_SHAPES)} VQ-f4 training shapes": TRAIN_VQ_FLASH_SHAPES,
              f"the {len(TP_FLASH_SHAPES)} tensor-parallel shapes": TP_FLASH_SHAPES,
              f"the {len(CONVERGENCE_FLASH_SHAPES)} convergence-probe shapes":
              CONVERGENCE_FLASH_SHAPES}
    rows = []
    for label, shapes in groups.items():
        part = []
        for shape in shapes:
            log_plan("K1", shape)
            row = flash_case(randn, shape)
            row["err"] = max(row["err"], flash_case(randn, shape, sharp=True, timed=False)["err"])
            part.append(row)
            free_memory()
        sums = {k: sum(r[k] for r in part) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"[K1 flash_attention] over {label}: kernel {sums['ms']:.4f} ms, plain "
            f"{sums['plain_ms']:.4f} ms, sdpa {sums['library_ms']:.4f} ms, bound "
            f"{sums['bound_ms']:.4f} ms")
        rows += part
    return rows


def log_ff_plan(shape) -> None:
    """K2's plan at ``shape`` per GEMM: a tile's rows and columns, the
    stages, the tiles (k splits counted), the persistent blocks and their
    clusters, and the tiles the busiest block runs."""
    from sd_tpu_torch.ops.cuda.geglu_ff import kernel_plan

    parts = []
    for name, p in kernel_plan(*shape).items():
        parts.append(f"{name} {p['rows']}x{p['cols']} tiles, {p['stages']} stages, "
                     f"{p['tiles']} tiles ({p['splits']} k splits) over {p['blocks']} blocks "
                     f"in clusters of {p['cluster']}, {-(-p['tiles'] // p['blocks'])} a block "
                     f"at most")
    log(f"[K2 plan] {shape}: " + "; ".join(parts))


def unfused_ff(x, w1, b1, w2, b2):
    """The FF as five bf16 library calls (cuBLAS): the yardstick of K2."""
    a, g = F.linear(x, w1, b1.to(x.dtype)).chunk(2, dim=-1)
    return F.linear(a * F.gelu(g), w2, b2.to(x.dtype))


def geglu_case(randn, shape, timed: bool = True) -> dict:
    """K2 at one (M, C, inner) against its plain version (fp32 on the same
    bf16 inputs). Timed: the kernel, the plain version, the unfused bf16 FF
    and the bound (h's round trip beside it)."""
    from sd_tpu_torch.ops.cuda import geglu_ff, geglu_ff_plain

    m, c, inner = shape
    args = [randn(m, c), randn(2 * inner, c) * c**-0.5, 0.1 * randn(2 * inner),
            randn(c, inner) * inner**-0.5, 0.1 * randn(c)]
    bf = [a.to(torch.bfloat16) if a.ndim == 2 else a for a in args]
    out = geglu_ff(*bf)
    torch.cuda.synchronize()
    err = check_error("K2 geglu_ff", shape, out, geglu_ff_plain(*[a.float() for a in bf]),
                      scale_floor=1.0)
    if not timed:
        return dict(err=err)
    ms = time_ms(lambda: geglu_ff(*bf))
    plain_ms = time_ms(lambda: geglu_ff_plain(*bf))
    unfused_ms = time_ms(lambda: unfused_ff(*bf))
    nbytes = (2 * m * c + 3 * inner * c) * 2 + (2 * inner + c) * 4 + m * c * 2
    bnd = bound(6 * m * c * inner, nbytes)
    h_ms = 2 * m * inner * 2 / PEAK_BYTES * 1e3
    log(f"[K2 geglu_ff] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, unfused "
        f"{unfused_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); h's round "
        f"trip {h_ms:.4f} ms of bytes")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None, unfused_ms=unfused_ms,
                **bnd)


def check_geglu(randn) -> list:
    rows = []
    groups = {"tensor-parallel": TP_FF_SHAPES, "convergence-probe": CONVERGENCE_FF_SHAPES}
    for shape in FF_SHAPES + RDM_FF_SHAPES + TP_FF_SHAPES + CONVERGENCE_FF_SHAPES:
        log_ff_plan(shape)
        rows.append(geglu_case(randn, shape))
        free_memory()
    end = len(rows)
    for label, shapes in reversed(groups.items()):
        part, end = rows[end - len(shapes):end], end - len(shapes)
        log(f"[K2 geglu_ff] over the {len(part)} {label} shapes: kernel "
            f"{sum(r['ms'] for r in part):.4f} ms, plain "
            f"{sum(r['plain_ms'] for r in part):.4f} ms, unfused "
            f"{sum(r['unfused_ms'] for r in part):.4f} ms, bound "
            f"{sum(r['bound_ms'] for r in part):.4f} ms")
    return rows


def flash_bwd_case(randn, shape, sharp: bool = False, timed: bool = True) -> dict:
    """K1 + K3 at one shape: the forward output of the autograd path, then
    dQ, dK and dV against the plain backward in fp32 on the same bf16
    inputs; with ``sharp``, q scaled by SHARP. Timed: K3, the plain
    backward, sdpa's backward (forward+backward minus forward), the bound."""
    from sd_tpu_torch.ops.cuda import (differentiable_flash_attention, flash_attention_bwd,
                                       flash_attention_bwd_plain, flash_attention_plain)
    from sd_tpu_torch.ops.cuda.flash_attention import _launch_forward

    b, n, h, d = shape
    scale = d**-0.5
    label = f"{shape}{' sharp' if sharp else ''}"
    q, k, v = (randn(*shape).to(torch.bfloat16) for _ in range(3))
    if sharp:
        q = q * SHARP
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    do = randn(*shape).to(torch.bfloat16)
    o = differentiable_flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    check_error("K1 differentiable_flash_attention", label, o,
                flash_attention_plain(*(t.detach().float() for t in (q, k, v)), scale))
    grads = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    q, k, v, o = (t.detach() for t in (q, k, v, o))
    refs = flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o, do)), scale)
    err = max(check_error(f"K3 flash_attention_bwd d{name}", label, g, r)
              for name, g, r in zip("QKV", grads, refs))
    if not timed:
        return dict(err=err)
    lse = _launch_forward(q, k, v, scale, with_lse=True)[1]
    ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, scale))
    plain_ms = time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, do, scale))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(*leaves, scale), leaves, do.transpose(1, 2))

    with torch.no_grad():
        fwd_ms = time_ms(lambda: sdpa(*leaves, scale))
    library_ms = time_ms(sdpa_fwd_bwd) - fwd_ms
    bnd = bound(10 * b * h * n * n * d, 8 * b * n * h * d * 2 + b * h * n * 4)
    log(f"[K3 flash_attention_bwd] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa fwd+bwd minus fwd {library_ms:.4f} ms ({sdpa_backend(q, k, v, scale)}), bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bnd)


def sdpa_backend(q, k, v, scale) -> str:
    """The backend scaled_dot_product_attention picks for these inputs."""
    from torch.nn.attention import SDPBackend

    try:
        choice = torch._fused_sdp_choice(*(t.transpose(1, 2) for t in (q, k, v)), scale=scale)
        return f"sdpa backend {SDPBackend(choice).name}"
    except (AttributeError, RuntimeError, TypeError, ValueError) as err:
        return f"sdpa backend not read: {err}"


def check_flash_bwd(randn) -> list:
    """K3 at the UNet's training shapes, at the first stage's mid-blocks
    (d = 512, its wide plan; K1's output and row log-sum-exp at those shapes
    too, which K3 reads) and at the VQ-f4 models' training shapes."""
    rows = []
    for shape in BWD_SHAPES + VAE_BWD_SHAPES + DP_VAE_BWD_SHAPES + TRAIN_VQ_BWD_SHAPES:
        log_plan("K3 dK/dV", shape)
        log_plan("K3 dQ", shape)
        if shape in VAE_BWD_SHAPES + DP_VAE_BWD_SHAPES:
            for sharp in (False, True):
                flash_case(randn, shape, sharp=sharp, timed=False)
        row = flash_bwd_case(randn, shape)
        row["err"] = max(row["err"], flash_bwd_case(randn, shape, sharp=True, timed=False)["err"])
        rows.append(row)
        free_memory()
    return rows


def int8_ff_case(randn, shape, timed: bool = True) -> dict:
    """K4 at one shape (M, C, inner) against its plain version (fp32 on the
    same bf16 inputs) within INT8_TOL["K4"], which bf16 K2 must fail; raises
    CheckFailed. Timed: the kernel, the plain version, bf16 K2 and the bound."""
    from sd_tpu_torch.ops.cuda import geglu_ff, geglu_ff_int8, geglu_ff_int8_plain
    from sd_tpu_torch.ops.cuda.geglu_ff import quantize_ff_weights

    m, c, inner = shape
    x = randn(m, c).to(torch.bfloat16)
    w1 = (randn(2 * inner, c) * c**-0.5).to(torch.bfloat16)
    w2 = (randn(c, inner) * inner**-0.5).to(torch.bfloat16)
    b1, b2 = 0.1 * randn(2 * inner), 0.1 * randn(c)
    qw = quantize_ff_weights(w1, w2, torch.bfloat16)
    out = geglu_ff_int8(x, w1, b1, w2, b2, qw)
    torch.cuda.synchronize()
    err = check_int8_error("K4", shape, out, geglu_ff_int8_plain(x.float(), qw, b1, b2),
                           {"K2": geglu_ff(x, w1, b1, w2, b2)}, scale_floor=1.0)
    if not timed:
        return dict(err=err)
    ms = time_ms(lambda: geglu_ff_int8(x, w1, b1, w2, b2, qw))
    plain_ms = time_ms(lambda: geglu_ff_int8_plain(x, qw, b1, b2))
    bf16_ms = time_ms(lambda: geglu_ff(x, w1, b1, w2, b2))
    nbytes = 2 * m * c * 2 + 3 * inner * c + (4 * inner + 2 * c) * 4
    bnd = bound(0, nbytes, int8_ops=6 * m * c * inner)
    log(f"[K4 geglu_ff_int8] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bf16 K2 {bf16_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bf16_ms=bf16_ms, **bnd)


def log_int8_ff_plan(shape) -> None:
    """The plans the library chooses for K4's two GEMMs at (M, C, inner)."""
    from sd_tpu_torch.ops.cuda.geglu_ff import int8_kernel_plan

    p = int8_kernel_plan(*shape)
    a, b = p["gemm1"], p["gemm2"]
    log(f"[K4 plan] {shape}: GEGLU GEMM {a['rows']} rows x {a['cols']} interleaved columns a "
        f"tile, {a['stages']} weight stages, {a['blocks']} blocks ({a['runs']} runs, "
        f"{a['tiles_per_block']} tiles a block), {a['smem_bytes']} bytes; output GEMM "
        f"{b['rows']} rows x {b['cols']} columns a block ({b['wgmma_cols']} a wgmma), "
        f"{b['h_stages']} h and {b['w_stages']} W2 stages, {b['blocks']} blocks, "
        f"{b['splits']} k splits, {b['smem_bytes']} bytes; scratch {p['scratch_ints']} int32")


def check_int8_ff(randn) -> list:
    rows = []
    for shape in INT8_FF_SHAPES:
        log_int8_ff_plan(shape)
        rows.append(int8_ff_case(randn, shape))
        free_memory()
    for shape in FLAGSHIP_INT8_FF_SHAPES:
        log_int8_ff_plan(shape)
        rows.append(int8_ff_case(randn, shape, timed=False))
    return rows


def int8_flash_case(randn, shape, timed: bool = True, gate: bool = True) -> dict:
    """K5 at one (B, N, H, D, mode) against its plain version (fp32 on the
    same bf16 inputs) within INT8_TOL; with ``gate``, K1's output (and in
    "qkpv" K5 "qk"'s) must read outside that bound. Timed: the kernel, the
    plain version, K1, sdpa and the bound."""
    from sd_tpu_torch.ops.cuda import (flash_attention, flash_attention_int8,
                                       flash_attention_int8_plain)

    b, n, h, d, mode = shape
    shape = (b, n, h, d)
    scale = d**-0.5
    bf = [randn(*shape).to(torch.bfloat16) for _ in range(3)]
    out = flash_attention_int8(*bf, scale, mode)
    torch.cuda.synchronize()
    unquantized = {"K1": flash_attention(*bf, scale)} if gate else {}
    if gate and mode == "qkpv":
        unquantized["K5 qk"] = flash_attention_int8(*bf, scale, "qk")
    err = check_int8_error(f"K5 {mode}", shape, out,
                           flash_attention_int8_plain(*[t.float() for t in bf], scale, mode),
                           unquantized)
    if not timed:
        return dict(err=err)
    ms = time_ms(lambda: flash_attention_int8(*bf, scale, mode))
    plain_ms = time_ms(lambda: flash_attention_int8_plain(*bf, scale, mode), iters=5)
    bf16_ms = time_ms(lambda: flash_attention(*bf, scale))
    library_ms = time_ms(lambda: sdpa(*bf, scale))
    products = 2 * b * h * n * n * d
    bnd = bound(0 if mode == "qkpv" else products, 4 * b * n * h * d * 2,
                int8_ops=2 * products if mode == "qkpv" else products)
    log(f"[K5 flash_attention_int8 {mode}] {shape}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bf16 K1 {bf16_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bf16_ms=bf16_ms,
                **bnd)


def check_int8_flash(randn) -> list:
    rows = []
    for shape in INT8_FLASH_SHAPES:
        log_plan(f"K5 {shape[4]}", shape[:4])
        rows.append(int8_flash_case(randn, shape))
        free_memory()
    for shape in FLAGSHIP_INT8_FLASH_SHAPES:
        log_plan(f"K5 {shape[4]}", shape[:4])
        rows.append(int8_flash_case(randn, shape, timed=False))
    for shape in INT8_FLASH_OFF_PATH:
        log_plan(f"K5 {shape[4]}", shape[:4])
        int8_flash_case(randn, shape, timed=False, gate=False)
    return rows


def int8_dense_case(randn, shape, timed: bool = True) -> dict:
    """K6 at one shape (M, C, F) against its plain version (fp32 on the same
    bf16 inputs) within INT8_TOL["K6"], which bf16 F.linear must fail; raises
    CheckFailed. Timed: the kernel, the plain version, F.linear,
    torch._int_mm on the same codes (the library's int8 product without the
    quantization or the epilogue: a yardstick only) and the bound."""
    from sd_tpu_torch.ops.cuda import int8_dense, int8_dense_plain
    from sd_tpu_torch.ops.cuda.geglu_ff import quantize_cols
    from sd_tpu_torch.ops.quant import quantize_rows

    m, c, f = shape
    x = randn(m, c).to(torch.bfloat16)
    w = (randn(f, c) * c**-0.5).to(torch.bfloat16)
    b = 0.1 * randn(f)
    wq, sw = quantize_cols(w)
    out = int8_dense(x, w, b, prequant=(wq, sw))
    torch.cuda.synchronize()
    bf16_b = b.to(torch.bfloat16)
    err = check_int8_error("K6", shape, out, int8_dense_plain(x.float(), wq, sw, b),
                           {"F.linear": F.linear(x, w, bf16_b)}, scale_floor=1.0)
    if not timed:
        return dict(err=err)
    xq = quantize_rows(x)[0]
    ms = time_ms(lambda: int8_dense(x, w, b, prequant=(wq, sw)))
    plain_ms = time_ms(lambda: int8_dense_plain(x, wq, sw, b))
    bf16_ms = time_ms(lambda: F.linear(x, w, bf16_b))
    int_mm_ms = time_ms(lambda: torch._int_mm(xq, wq.t()))
    bnd = bound(0, m * c * 2 + f * c + f * 8 + m * f * 2, int8_ops=2 * m * c * f)
    log(f"[K6 int8_dense] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 F.linear "
        f"{bf16_ms:.4f} ms, torch._int_mm on the codes {int_mm_ms:.4f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bf16_ms=bf16_ms,
                int_mm_ms=int_mm_ms, **bnd)


def log_int8_dense_plan(shape) -> None:
    """The plan the library chooses for K6 at (M, C, F)."""
    dense = importlib.import_module("sd_tpu_torch.ops.cuda.int8_dense")
    p = dense.kernel_plan(*shape)
    log(f"[K6 plan] {shape}: {p['rows']} rows x {p['cols']} columns a tile, {p['stages']} "
        f"weight stages, {p['blocks']} blocks ({p['runs']} runs of F, {p['tiles_per_block']} "
        f"tiles a block), {p['smem_bytes']} bytes of shared memory")


def check_int8_dense(randn) -> list:
    rows = []
    for shape in INT8_DENSE_SHAPES:
        log_int8_dense_plan(shape)
        rows.append(int8_dense_case(randn, shape))
    return rows


def check_int8_conv(randn) -> None:
    """The int8 conv (stock PyTorch: im2col, torch._int_mm) against its
    float64 plain version on the same codes, at UNet sites of each level and
    the VAE decoder's conv_out (Cout 3, padded to 8), with its ms beside
    cuDNN's bf16 conv."""
    from sd_tpu_torch.ops import quant

    for b, cin, hw, cout in ((2, 320, 64, 320), (2, 640, 32, 640), (2, 1280, 16, 1280),
                             (1, 128, 512, 3)):
        x = randn(b, cin, hw, hw).to(torch.bfloat16)
        w = (randn(cout, cin, 3, 3) * (9 * cin) ** -0.5).to(torch.bfloat16)
        bias = 0.1 * randn(cout)
        kq, sw = quant.quantize_conv_kernel(w)
        out = quant.int8_conv3x3(x, w, bias, (kq, sw))
        torch.cuda.synchronize()
        xq, sx = quant._quantize_tensor(x)
        check_error("int8_conv3x3", (b, cin, hw, hw, cout), out,
                    quant.int8_conv3x3_plain(xq, sx, kq, sw, bias, torch.float32),
                    scale_floor=1.0)
        ms = time_ms(lambda: quant.int8_conv3x3(x, w, bias, (kq, sw)))
        bf16_b = bias.to(torch.bfloat16)
        bf16_ms = time_ms(lambda: F.conv2d(x, w, bf16_b, padding=1))
        log(f"[int8_conv3x3] {(b, cin, hw, hw, cout)}: {ms:.4f} ms, cuDNN bf16 {bf16_ms:.4f} ms")


def _fused_bound(b, c, hw, n, second):
    """K7's least time: its products, and its inputs and outputs once each."""
    px = b * hw * hw
    nbytes = px * c * 2 + 9 * c * n * 2 + 2 * b * c * 4 + px * n * 2
    nbytes += (n * 4 + px * n * 2) if second else 2 * b * n * 4
    return bound(2 * px * 9 * c * n, nbytes)


@torch.no_grad()
def fused_conv_case(randn, shape, timed: bool = True) -> dict:
    """K7 at one launch (B, C, H=W, N, "first" | "second") of the fused
    serving path, as the resnet blocks call it when serving (no autograd,
    the weight repacked beforehand), against its plain version in fp32 on
    the same bf16 inputs (y and the moments); raises CheckFailed. Timed: the
    kernel, the plain version, the unfused site, cuDNN's conv alone on h and
    the bound."""
    from sd_tpu_torch.ops.cuda import fused_conv3x3, fused_conv3x3_plain
    from sd_tpu_torch.ops.cuda.fused_conv import fold_gn_affine, repack_weight
    from sd_tpu_torch.ops.norms import GroupNorm32, group_stats

    b, c, hw, n, launch = shape
    shape = (b, c, hw, hw, n, launch)
    second = launch == "second"
    x = randn(b, c, hw, hw).to(torch.bfloat16)
    w = (randn(n, c, 3, 3) * (9 * c) ** -0.5).to(torch.bfloat16)
    gn = GroupNorm32(c).to(x.device, torch.bfloat16)
    with torch.no_grad():
        gn.weight.copy_(1.0 + 0.1 * randn(c))
        gn.bias.copy_(0.1 * randn(c))
    a, d = fold_gn_affine(*group_stats(x, 32), gn.weight.float(), gn.bias.float(), gn.eps)
    bias = 0.1 * randn(n)
    skip = randn(b, n, hw, hw).to(torch.bfloat16)
    kw = dict(a=a, d=d, bias=bias, skip=skip) if second else dict(a=a, d=d, emit_moments=True)
    wk = repack_weight(w)
    got = fused_conv3x3(x, w, wk=wk, **kw)
    torch.cuda.synchronize()
    ref_kw = dict(kw, skip=skip.float()) if second else kw
    ref = fused_conv3x3_plain(x.float(), w.float(), **ref_kw)
    if second:
        got, ref = (got,), (ref,)
    # the second launch's bound scales with the branch it adds to skip, so
    # that a fault in the conv shows however large the skip is
    err = check_error("K7 fused_conv3x3", shape, got[0], ref[0], scale_floor=1.0,
                      residual=skip if second else None)
    for name, g, r in zip(("sum", "sum of squares"), got[1:], ref[1:]):
        check_error(f"K7 fused_conv3x3 moments {name}", shape, g, r)
    if not timed:
        return dict(err=err)
    bf16_b = bias.to(torch.bfloat16)

    def unfused():
        h = F.conv2d(F.silu(gn(x)), w, bf16_b, padding=1)
        if second:
            return h + skip
        return group_stats(h, 32)

    h = F.silu(gn(x))
    ms = time_ms(lambda: fused_conv3x3(x, w, wk=wk, **kw))
    plain_ms = time_ms(lambda: fused_conv3x3_plain(x, w, **kw), iters=5)
    unfused_ms = time_ms(unfused)
    conv_ms = time_ms(lambda: F.conv2d(h, w, bf16_b, padding=1))
    bnd = _fused_bound(b, c, hw, n, second)
    log(f"[K7 fused_conv3x3] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, unfused "
        f"site {unfused_ms:.4f} ms, cuDNN conv alone {conv_ms:.4f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None, unfused_ms=unfused_ms,
                conv_ms=conv_ms, **bnd)


def log_fused_plan(shape) -> None:
    """The plan the library chooses for K7 at (B, C, H=W, N, launch)."""
    from sd_tpu_torch.ops.cuda.fused_conv import kernel_plan

    b, c, hw, n, _ = shape
    p = kernel_plan(b, c, hw, hw, n)
    log(f"[K7 plan] {shape[:4]}: {p['rows']} x {p['cols']} pixels x {p['channels']} channels "
        f"a block, {p['stages']} weight stages, {p['splits']} split(s) over C of "
        f"{p['steps_per_split']} 64-channel steps, {p['blocks']} blocks, {p['smem_bytes']} "
        f"bytes of shared memory")


def check_fused_conv(randn) -> list:
    """K7 at every launch of the fused serving path, with its gradient."""
    rows = []
    for shape in FUSED_SHAPES:
        log_fused_plan(shape)
        rows.append(fused_conv_case(randn, shape))
        free_memory()
    for shape in TIMESTEP_FUSED_SHAPES:
        log_fused_plan(shape)
        rows.append(fused_conv_case(randn, shape, timed=False))
        free_memory()
    check_fused_grad(randn)
    return rows


def check_fused_grad(randn) -> None:
    """One gradient through K7's autograd function (bf16 inputs, every
    flag) against the plain backward in fp32 on the same inputs."""
    from sd_tpu_torch.ops.cuda import fused_conv3x3, fused_conv3x3_plain

    b, c, hw, n = 2, 640, 32, 640
    vals = [randn(b, c, hw, hw).to(torch.bfloat16), (randn(n, c, 3, 3) * (9 * c) ** -0.5
                                                      ).to(torch.bfloat16),
            1.0 + 0.1 * randn(b, c), 0.3 * randn(b, c), 0.1 * randn(n),
            randn(b, n, hw, hw).to(torch.bfloat16)]
    gy, g1, g2 = randn(b, n, hw, hw), randn(b, n) * 1e-2, randn(b, n) * 1e-4
    names = ("x", "w", "a", "d", "bias", "skip")

    def grads(fn, leaves):
        x, w, a, d, bias, skip = leaves
        y, s1, s2 = fn(x, w, a, d, bias, skip)
        loss = (y.float() * gy).sum() + (s1 * g1).sum() + (s2 * g2).sum()
        return torch.autograd.grad(loss, leaves)

    leaves = [v.clone().requires_grad_() for v in vals]
    got = grads(lambda x, w, a, d, bias, skip: fused_conv3x3(
        x, w, a=a, d=d, bias=bias, skip=skip, emit_moments=True), leaves)
    ref_leaves = [v.float().requires_grad_() for v in vals]
    want = grads(lambda *t: fused_conv3x3_plain(*t, emit_moments=True), ref_leaves)
    torch.cuda.synchronize()
    for name, g, r in zip(names, got, want):
        rel = ((g.float() - r).norm() / r.norm()).item()
        ok = bool(torch.isfinite(g).all()) and rel <= FUSED_GRAD_TOL
        log(f"[K7 gradient] d{name}: relative L2 {rel:.3e} against the plain backward in fp32 "
            f"(bound {FUSED_GRAD_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K7 gradient d{name}: relative L2 {rel}")


def log_winograd_plan(label: str, x_shape, k: int, split: bool) -> None:
    """The launch plan the library chooses for K8 or X3 at this shape."""
    from sd_tpu_torch.ops.cuda.winograd_conv import kernel_plan

    plan = kernel_plan(x_shape, k, split)
    slots = plan["blocks_per_sm"] * torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[{label} plan] {tuple(x_shape)}->{k}: plan {plan['plan']}, "
        f"{plan['tile_rows']} x {plan['tile_cols']} tiles and {plan['channels']} channels a "
        f"block, {plan['channel_step']} input channels a step, {plan['threads']} threads, "
        f"{plan['smem_bytes']} bytes of shared memory, {plan['blocks_per_sm']} blocks per SM; "
        f"{plan['blocks']} blocks, {plan['blocks'] / slots:.2f} waves")


def winograd_case(randn, shape, timed: bool = True) -> dict:
    """K8 and X3 at one shape (B, C, H, W, K), given U (the weight transform
    rounded to bf16, as Conv3x3 keeps it), against their plain version (fp32
    on the same bf16 inputs) and against F.conv2d in fp32; raises
    CheckFailed on either. Timed: each kernel's ms with U given, the whole
    wrapper's ms (U computed in the call), the plain version's, F.conv2d's
    in bf16 and the bound."""
    from sd_tpu_torch.ops.cuda import (winograd_conv3x3, winograd_conv3x3_plain,
                                       winograd_conv3x3_split)
    from sd_tpu_torch.ops.cuda.winograd_conv import weight_transform

    b, c, h, wd, k = shape
    x = randn(b, c, h, wd).to(torch.bfloat16)
    w = (randn(k, c, 3, 3) * (9 * c) ** -0.5).to(torch.bfloat16)
    u = weight_transform(w).to(torch.bfloat16).contiguous()
    ref = winograd_conv3x3_plain(x.float(), w.float())
    direct = F.conv2d(x.float(), w.float(), padding=1)
    rows = {}
    for name, fn, label in (("winograd_conv3x3", winograd_conv3x3, "K8"),
                            ("winograd_conv3x3_split", winograd_conv3x3_split, "X3")):
        got = fn(x, w, u=u)
        torch.cuda.synchronize()
        err = check_error(f"{label} {name}", shape, got, ref)
        check_error(f"{label} {name} against F.conv2d", shape, got, direct)
        rows[name] = dict(err=err)
    if not timed:
        return rows
    plain_ms = time_ms(lambda: winograd_conv3x3_plain(x, w), iters=5)
    library_ms = time_ms(lambda: F.conv2d(x, w, padding=1))
    bnd = bound(2 * b * (h // 2) * (wd // 2) * 16 * c * k,
                b * c * h * wd * 2 + 9 * c * k * 2 + b * k * h * wd * 2)
    for name, fn, label in (("winograd_conv3x3", winograd_conv3x3, "K8"),
                            ("winograd_conv3x3_split", winograd_conv3x3_split, "X3")):
        log_winograd_plan(label, x.shape, k, name.endswith("split"))
        ms = time_ms(lambda: fn(x, w, u=u))
        call_ms = time_ms(lambda: fn(x, w))
        log(f"[{label} {name}] {shape}: kernel {ms:.4f} ms (U given), whole call {call_ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, F.conv2d {library_ms:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows[name].update(ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
                          **bnd)
    return rows


def check_winograd(randn) -> dict:
    """K8 and X3 at every K8 site of the serving path and at the X3
    experiment's levels (the rows of the kernels line), then at the ragged
    shapes of WINO_RAGGED (checked and timed, not summed)."""
    rows = {"winograd_conv3x3": [], "winograd_conv3x3_split": []}
    for b, c, hw, k in WINO_SHAPES + X3_LEVELS:
        for name, row in winograd_case(randn, (b, c, hw, hw, k)).items():
            rows[name].append(row)
    for shape in WINO_RAGGED:
        winograd_case(randn, shape)
    return rows


def x3_experiment() -> dict:
    """The X3 experiment path (tools/exp_winograd.py's timing_split): one
    in-kernel-split Winograd conv at each UNet level at B=16, against the
    direct conv; returns the launch counts of that run."""
    from sd_tpu_torch.ops.cuda import winograd_conv3x3_split

    g = torch.Generator(device="cuda").manual_seed(2)
    reset_launches()
    for b, c, hw, k in X3_LEVELS:
        x = torch.randn((b, c, hw, hw), generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn((k, c, 3, 3), generator=g, device="cuda") * 0.02).to(torch.bfloat16)
        got = winograd_conv3x3_split(x, w)
        check_error("X3 experiment", (b, c, hw, hw, k), got, F.conv2d(x.float(), w.float(),
                                                                       padding=1))
    counts = read_launches()
    want = expect(winograd_conv3x3_split=len(X3_LEVELS))
    log(f"[X3 experiment] launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError(f"X3 experiment launches {counts} != {want}")
    return counts


def _block_bound(b, n, c, heads):
    """X1's least time: the tool's CostEstimate flops, x read and the output
    written once, the four weights and three vectors read once."""
    d = c // heads
    nbytes = 2 * b * n * c * 2 + 4 * c * c * 2 + 3 * c * 4
    return bound(8 * b * n * c * c + 4 * b * heads * n * n * d, nbytes)


def _tail_bound(b, n, c, heads, inner, kv_len):
    """X2's least time: the tool's CostEstimate flops plus QKᵀ and P·V over
    kv_len keys; x, the live kc/vc rows, the weights and vectors read once,
    the output written once."""
    nbytes = (2 * b * n * c + 2 * b * kv_len * c + 2 * c * c + 3 * c * inner) * 2
    nbytes += (6 * c + 2 * inner) * 4
    return bound(4 * b * n * c * c + 6 * b * n * c * inner + 4 * b * n * kv_len * c, nbytes)


def _fp32(args: dict) -> dict:
    return {k: v.float() if torch.is_tensor(v) else v for k, v in args.items()}


def check_x1_site(n: int, c: int):
    """X1 on the experiment's inputs at (N, C), B=16, against its plain
    version in fp32, within KERNEL_TOL of the branch's max; returns (x, the
    keyword arguments, the max abs error)."""
    from sd_tpu_torch.ops.cuda import fused_block, fused_block_plain
    from sd_tpu_torch.scripts import exp_block_kernel as exp

    x, args = exp.block_inputs(n, c, "cuda", seed=n)
    got = fused_block(x, **args)
    torch.cuda.synchronize()
    err = check_error("X1 fused_block", tuple(x.shape), got,
                      fused_block_plain(x.float(), **_fp32(args)), residual=x)
    return x, args, err


def check_x2_site(n: int, c: int, batch: int = 16):
    """X2 as :func:`check_x1_site` (at ``batch``), every context row non-zero:
    only the mask keeps rows >= kv_len out."""
    from sd_tpu_torch.ops.cuda import tail_fused, tail_fused_plain
    from sd_tpu_torch.scripts import exp_block_kernel as exp

    x, args = exp.tail_inputs(n, c, "cuda", seed=n + 1, batch=batch)
    got = tail_fused(x, **args)
    torch.cuda.synchronize()
    err = check_error("X2 tail_fused", tuple(x.shape), got,
                      tail_fused_plain(x.float(), **_fp32(args)), residual=x)
    return x, args, err


def check_block_kernels() -> dict:
    """X1 and X2 at SD v1's four transformer sites at B=16 against their
    plain versions (fp32 on the same bf16 inputs), beside the unfused
    yardstick; then X1∘X2 on a port BasicTransformerBlock against the block."""
    from sd_tpu_torch.ops.attention import BasicTransformerBlock
    from sd_tpu_torch.ops.cuda import (fused_block, fused_block_plain, tail_fused,
                                       tail_fused_plain)
    from sd_tpu_torch.ops.cuda.fused_block import x1_plan, x2_plan
    from sd_tpu_torch.scripts import exp_block_kernel as exp
    from sd_tpu_torch.utils.config import init_random_

    g = torch.Generator(device="cuda").manual_seed(4)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    b, heads, kv_len = exp.B, exp.HEADS, exp.KV_LEN
    rows = {"fused_block": [], "tail_fused": []}
    for n, c in BLOCK_SITES:
        shape = (b, n, c)
        plan = x1_plan(b, n, c, c // heads)
        log(f"[X1 plan] {shape}: LN + QKV {plan['qkv']}; attention + out-projection "
            f"{plan['attn']}")
        x, args, err = check_x1_site(n, c)
        mods = exp.self_attention_modules(**args, dtype=x.dtype)
        ms = time_ms(lambda: fused_block(x, **args))
        plain_ms = time_ms(lambda: fused_block_plain(x, **args), iters=3, warmup=1)
        unfused_ms = time_ms(lambda: exp.unfused_block(x, *mods))
        bnd = _block_bound(b, n, c, heads)
        log(f"[X1 fused_block] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, unfused "
            f"{unfused_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows["fused_block"].append(dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                                        unfused_ms=unfused_ms, **bnd))

        log_x2_plan(b, n, c)
        x, args, err = check_x2_site(n, c)
        kc, vc = args["kc"], args["vc"]
        weights = {k: v for k, v in args.items() if k not in ("kc", "vc", "kv_len")}
        mods = exp.tail_modules(**weights, dtype=x.dtype)
        ms = time_ms(lambda: tail_fused(x, **args))
        plain_ms = time_ms(lambda: tail_fused_plain(x, **args), iters=3, warmup=1)
        unfused_ms = time_ms(lambda: exp.tail_unfused(x, kc, vc, kv_len, *mods))
        bnd = _tail_bound(b, n, c, heads, 4 * c, kv_len)
        log(f"[X2 tail_fused] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, unfused "
            f"{unfused_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows["tail_fused"].append(dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                                       unfused_ms=unfused_ms, **bnd))

        block = BasicTransformerBlock(c, heads, c // heads, context_dim=CONTEXT_DIM)
        init_random_(block, torch.Generator().manual_seed(n))
        block = block.to("cuda", torch.bfloat16).eval()
        x = randn(b, n, c).to(torch.bfloat16)
        ctx = randn(b, kv_len, CONTEXT_DIM).to(torch.bfloat16)
        with torch.no_grad():
            fused = exp.fused_transformer_block(block, x, ctx)
            want = block(x, ctx)
        rel = exp.relative_l2(fused, want)
        ok = bool(torch.isfinite(fused).all()) and rel <= BLOCK_AGREEMENT_TOL
        log(f"[X1∘X2 block] {shape}: a port BasicTransformerBlock through X1 and X2 against the "
            f"block, bf16: relative L2 {rel:.3e} (bound {BLOCK_AGREEMENT_TOL}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"X1∘X2 at {shape}: relative L2 {rel}")
        del x, args, mods, block, kc, vc, weights
        free_memory()
    for b_off, n, c in X2_OFF_GRID:
        log_x2_plan(b_off, n, c)
        err = check_x2_site(n, c, batch=b_off)[2]
        rows["tail_fused"][-1]["err"] = max(rows["tail_fused"][-1]["err"], err)
    return rows


def log_x2_plan(b: int, n: int, c: int) -> None:
    """X2's plans at [b, n, c] with the experiment's heads, keys and inner:
    the attention launch's row tile, blocks and column split, LN3's route
    and K2's plan per GEMM."""
    from sd_tpu_torch.ops.cuda.fused_block import x2_plan
    from sd_tpu_torch.scripts import exp_block_kernel as exp

    p = x2_plan(b, n, c, c // exp.HEADS, exp.KV_LEN, 4 * c)
    a = p["attn"]
    ff = "; ".join(f"{k} {g['rows']}x{g['cols']} tiles, {g['tiles']} tiles ({g['splits']} k "
                   f"splits) over {g['blocks']} blocks in clusters of {g['cluster']}"
                   for k, g in (("gemm1", p["gemm1"]), ("gemm2", p["gemm2"])))
    log(f"[X2 plan] {(b, n, c)}: LN2 + Q {p['q']['rows']}x{p['q']['cols']} tiles, "
        f"{p['q']['blocks']} blocks; attention + out-projection {a['rows']} rows a block, "
        f"{a['blocks']} blocks ({a['threads']} threads, {a['blocks_per_sm']} an SM), "
        f"{a['column_splits']} column splits; LN3 "
        f"{'in its own launch' if p['ln3_own_launch'] else 'in the attention launch'}; K2 {ff}")


def block_experiment() -> dict:
    """The block experiment's two entry points at their defaults, through
    main(); exact launches of each; returns the counts of both runs."""
    from sd_tpu_torch.scripts import exp_block_kernel as exp

    per_step = 2 + exp.REPS * exp.ITERS  # the check, the warm-up step, the chained runs
    total = {}
    for argv, want in (([], expect(fused_block=per_step, flash_attention=per_step)),
                       (["tail"], expect(tail_fused=per_step, geglu_ff=per_step))):
        reset_launches()
        result = exp.main(argv)
        counts = read_launches()
        log(f"[block experiment] {' '.join(['exp_block_kernel', *argv])}: {result}; launches "
            f"{counts}, expected {want}")
        if counts != want:
            raise AssertionError(f"block experiment {argv}: launches {counts} != {want}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def check_conv_kernels() -> dict:
    g = torch.Generator(device="cuda").manual_seed(3)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    timings = {"fused_conv3x3": check_fused_conv(randn)}
    timings.update(check_winograd(randn))
    return timings


def check_ldm_1p4b_shapes(randn) -> dict:
    """K1 (output and lse) and K3 at LDM_1P4B_FLASH_SHAPES and
    LDM_1P4B_BWD_SHAPES, plain and sharp, and K2 at LDM_1P4B_FF_SHAPES,
    untimed: each kernel's rows, {"err": ...} each."""
    rows = {"flash_attention": [], "flash_attention_bwd": [], "geglu_ff": []}
    for shape in LDM_1P4B_FLASH_SHAPES:
        log_plan("K1", shape)
        rows["flash_attention"].append({"err": max(
            flash_case(randn, shape, sharp=sharp, timed=False)["err"] for sharp in (False, True))})
    for shape in LDM_1P4B_BWD_SHAPES:
        log_plan("K3 dK/dV", shape)
        log_plan("K3 dQ", shape)
        rows["flash_attention_bwd"].append({"err": max(
            flash_bwd_case(randn, shape, sharp=sharp, timed=False)["err"]
            for sharp in (False, True))})
    for shape in LDM_1P4B_FF_SHAPES:
        log_ff_plan(shape)
        rows["geglu_ff"].append(geglu_case(randn, shape, timed=False))
    free_memory()
    return rows


def check_kernels() -> dict:
    """K1, K2 and K3: rows timed at the serving and SD v1 training shapes,
    then untimed rows at the 1.4B training's own shapes."""
    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    timings = {"flash_attention": check_flash(randn), "geglu_ff": check_geglu(randn),
               "flash_attention_bwd": check_flash_bwd(randn)}
    for k, rows in check_ldm_1p4b_shapes(randn).items():
        timings[k] += rows
    return timings


def check_int8_kernels() -> dict:
    g = torch.Generator(device="cuda").manual_seed(1)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    check_int8_conv(randn)
    return {"geglu_ff_int8": check_int8_ff(randn), "flash_attention_int8": check_int8_flash(randn),
            "int8_dense": check_int8_dense(randn)}


def check_reference() -> None:
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline
    from sd_tpu_torch.pipelines.txt2img import Txt2ImgPipeline

    cpu_pipe, hw = build_txt2img_pipeline(tiny=True, device="cpu", seed=0, watermark=False,
                                          safety=False)
    card_ldm = copy.deepcopy(cpu_pipe.ldm).to(device="cuda", dtype=torch.bfloat16)
    card_pipe = Txt2ImgPipeline(ldm=card_ldm, tokenizer=cpu_pipe.tokenizer,
                                downsample=cpu_pipe.downsample)
    x_T = np.random.default_rng(0).standard_normal((2, hw // 2, hw // 2, 4)).astype(np.float32)
    run = dict(height=hw, width=hw, steps=5, guidance_scale=7.5)
    prompts = [PROMPT, "a red cube"]
    images = cpu_pipe(prompts, x_T=torch.from_numpy(x_T), **run)
    card_pipe(prompts, x_T=torch.from_numpy(x_T).cuda(), **run)
    want = cpu_pipe.last_latents
    got = card_pipe.last_latents.cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"[reference] tiny model, bf16 card vs fp32 CPU, PLMS 5: max |diff| / max |ref| "
        f"= {rel:.3e} (bound {REFERENCE_TOL})")
    if not (np.isfinite(rel) and rel <= REFERENCE_TOL):
        raise AssertionError(f"tiny model disagrees with its fp32 CPU reference: {rel}")
    check_sampler_reference(cpu_pipe, card_pipe, x_T, prompts)
    check_img2img_reference(cpu_pipe, card_pipe, prompts)
    check_ancestral_reference(cpu_pipe, card_pipe, x_T, prompts)
    check_safety_reference(images)


def check_sampler_reference(cpu_pipe, card_pipe, x_T: np.ndarray, prompts) -> None:
    """DDIM at eta 0 and 1 and DPM-Solver++ at orders 2 and 3, 5 steps with
    guidance 7.5, on the tiny model's weights in bf16 on the card against
    fp32 on the CPU: the same x_T, and DDIM's noise drawn on the CPU once and
    moved to the card."""
    from sd_tpu_torch.samplers.ddim import ddim_sample
    from sd_tpu_torch.samplers.dpm_solver import dpm_solver_sample

    gen = torch.Generator().manual_seed(11)
    noise = [torch.randn((len(prompts), 4) + x_T.shape[1:3], generator=gen) for _ in range(5)]
    sched = cpu_pipe.ldm.schedule
    runs = {"DDIM eta 0": lambda f, x, c, u, z: ddim_sample(f, sched, x, c, 5, 0.0, u, 7.5),
            "DDIM eta 1": lambda f, x, c, u, z: ddim_sample(f, sched, x, c, 5, 1.0, u, 7.5,
                                                            noise=z),
            "DPM-Solver++ order 2": lambda f, x, c, u, z: dpm_solver_sample(
                f, sched, x, c, 5, u, 7.5, order=2),
            "DPM-Solver++ order 3": lambda f, x, c, u, z: dpm_solver_sample(
                f, sched, x, c, 5, u, 7.5, order=3)}
    for name, run in runs.items():
        out = []
        for pipe in (cpu_pipe, card_pipe):
            device = pipe.device
            x = torch.from_numpy(x_T).permute(0, 3, 1, 2).to(device)
            with torch.inference_mode():
                z = run(pipe.ldm.apply_model, x, pipe.encode_prompts(prompts),
                        pipe.encode_prompts([""] * len(prompts)), [t.to(device) for t in noise])
            out.append(z.float().cpu())
        want, got = out
        rel = ((got - want).abs().max() / want.abs().max()).item()
        log(f"[reference] tiny model, bf16 card vs fp32 CPU, {name}, 5 steps: max |diff| / "
            f"max |ref| = {rel:.3e} (bound {REFERENCE_TOL})")
        if not (np.isfinite(rel) and rel <= REFERENCE_TOL):
            raise AssertionError(f"{name}: the card disagrees with the CPU: {rel}")


def _relative(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float().cpu() - want).abs().max() / want.abs().max()).item()


def check_img2img_reference(cpu_pipe, card_pipe, prompts) -> None:
    """Img2ImgPipeline at strength 0.5, DDIM 6 (t_enc 3), guidance 7.5, on
    the tiny model's weights in bf16 on the card against fp32 on the CPU:
    one synthetic 64² init image, and the posterior's and the stochastic
    encode's noise drawn on the CPU once and moved; the latents it decodes
    within REFERENCE_TOL."""
    from sd_tpu_torch.pipelines.img2img import Img2ImgPipeline

    hw = 64
    gen = torch.Generator().manual_seed(12)
    noise = [torch.randn((len(prompts), hw // 2, hw // 2, 4), generator=gen) for _ in range(2)]
    out = []
    for pipe in (cpu_pipe, card_pipe):
        i2i = Img2ImgPipeline(pipe)
        i2i(synthetic_image(hw, seed=1), prompts, strength=0.5, steps=6, guidance_scale=7.5,
            noise=[n.to(pipe.device) for n in noise])
        out.append(i2i.last_latents.float().cpu())
    rel = _relative(out[1], out[0])
    log(f"[reference] tiny model, bf16 card vs fp32 CPU, img2img at strength 0.5, DDIM 6: "
        f"max |diff| / max |ref| = {rel:.3e} (bound {REFERENCE_TOL})")
    if not (np.isfinite(rel) and rel <= REFERENCE_TOL):
        raise AssertionError(f"img2img: the card disagrees with the CPU: {rel}")


def check_ancestral_reference(cpu_pipe, card_pipe, x_T: np.ndarray, prompts) -> None:
    """p_sample_loop over the first 8 DDPM timesteps with guidance 7.5, on
    the tiny model's weights in bf16 on the card against fp32 on the CPU:
    the same x_T and per-step noise, drawn on the CPU once and moved."""
    from sd_tpu_torch.samplers.ancestral import p_sample_loop

    gen = torch.Generator().manual_seed(13)
    shape = (len(prompts), 4) + x_T.shape[1:3]
    noise = [torch.randn(shape, generator=gen) for _ in range(8)]
    out = []
    for pipe in (cpu_pipe, card_pipe):
        device = pipe.device
        x = torch.from_numpy(x_T).permute(0, 3, 1, 2).to(device)
        with torch.inference_mode():
            z = p_sample_loop(pipe.ldm.apply_model, pipe.ldm.schedule, shape,
                              pipe.encode_prompts(prompts),
                              uncond=pipe.encode_prompts([""] * len(prompts)),
                              guidance_scale=7.5, x_T=x, timesteps=8,
                              noise=[t.to(device) for t in noise])
        out.append(z.float().cpu())
    rel = _relative(out[1], out[0])
    log(f"[reference] tiny model, bf16 card vs fp32 CPU, ancestral p_sample_loop over 8 "
        f"timesteps: max |diff| / max |ref| = {rel:.3e} (bound {REFERENCE_TOL})")
    if not (np.isfinite(rel) and rel <= REFERENCE_TOL):
        raise AssertionError(f"p_sample_loop: the card disagrees with the CPU: {rel}")


def synthetic_image(size: int, seed: int) -> np.ndarray:
    """A seeded uint8 RGB gradient with noise, ``[size, size, 3]``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    img = np.stack([xx, yy, 0.5 * (xx + yy)], -1) * 255 + rng.normal(0, 16, (size, size, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def check_safety_reference(images: np.ndarray) -> None:
    """The untrained safety checker, its tower in bf16 on the card (K1 at
    its two self-attention layers) against fp32 on the CPU, on the tiny
    model's CPU images: the embeddings within SAFETY_EMBED_TOL, the flags
    equal at the untrained thresholds (none flagged) and at -2 (all)."""
    from sd_tpu_torch.pipelines.safety import SafetyChecker

    cpu = SafetyChecker.untrained()
    card = copy.deepcopy(cpu).cuda()
    card.vision_model.to(torch.bfloat16)
    reset_launches()
    got = card.image_embeds(torch.from_numpy(images).cuda()).cpu()
    launches = read_launches()["flash_attention"]
    want = cpu.image_embeds(torch.from_numpy(images))
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"[reference] untrained safety checker, bf16 tower on the card vs fp32 CPU, "
        f"{images.shape}: embeddings max |diff| / max |ref| = {rel:.3e} (bound "
        f"{SAFETY_EMBED_TOL}); K1 launches {launches}")
    if not (np.isfinite(rel) and rel <= SAFETY_EMBED_TOL) or launches != UNTRAINED_LAYERS:
        raise AssertionError(f"safety checker on the card: {rel}, {launches} K1 launches")
    for threshold, want_flag in ((2.0, False), (-2.0, True)):
        flags = []
        for checker in (cpu, card):
            with torch.no_grad():
                checker.concept_embeds_weights.fill_(threshold)
                checker.special_care_embeds_weights.fill_(threshold)
            device = checker.concept_embeds.device
            flags.append(checker.nsfw_scores(torch.from_numpy(images).to(device)).cpu())
        if not (torch.equal(*flags) and bool((flags[0] == want_flag).all())):
            raise AssertionError(f"safety flags at threshold {threshold}: {flags}")


def check_fp32_reference() -> None:
    """The fp32 opt-out on the card. SD_TPU_PRECISION=fp32 builds the tiny
    model in fp32; with the CPU model's weights it samples (PLMS 5) against
    the fp32 CPU run. Then one tiny training loss and its UNet gradients in
    fp32 outside autocast against the CPU. TF32 is off for matmul and cuDNN
    (main() sets both). Neither run may launch K1, K2 or K3, whose kernels
    are bf16: the plain versions serve fp32."""
    from sd_tpu_torch.data.base import collate
    from sd_tpu_torch.data.synthetic import SyntheticImages
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline
    from sd_tpu_torch.training.diffusion_loss import LDMTrainer
    from sd_tpu_torch.utils.config import build_latent_diffusion, train_config

    cpu_pipe, hw = build_txt2img_pipeline(tiny=True, device="cpu", seed=0, watermark=False,
                                          safety=False)
    before = os.environ.get("SD_TPU_PRECISION")
    os.environ["SD_TPU_PRECISION"] = "fp32"
    try:
        card_pipe, _ = build_txt2img_pipeline(tiny=True, device="cuda", seed=0,
                                              watermark=False, safety=False)
    finally:
        if before is None:
            del os.environ["SD_TPU_PRECISION"]
        else:
            os.environ["SD_TPU_PRECISION"] = before
    dtypes = {p.dtype for p in card_pipe.ldm.parameters()}
    if dtypes != {torch.float32}:
        raise AssertionError(f"SD_TPU_PRECISION=fp32 built the model in {dtypes}")
    card_pipe.ldm.load_state_dict(cpu_pipe.ldm.state_dict())
    x_T = np.random.default_rng(0).standard_normal((2, hw // 2, hw // 2, 4)).astype(np.float32)
    run = dict(height=hw, width=hw, steps=5, guidance_scale=7.5)
    prompts = [PROMPT, "a red cube"]
    cpu_pipe(prompts, x_T=torch.from_numpy(x_T), **run)
    reset_launches()
    card_pipe(prompts, x_T=torch.from_numpy(x_T).cuda(), **run)
    sampled = read_launches()
    want = cpu_pipe.last_latents
    got = card_pipe.last_latents.cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"[fp32 reference] tiny model, SD_TPU_PRECISION=fp32 on the card vs fp32 CPU, PLMS 5: "
        f"latents {got.dtype}, max |diff| / max |ref| = {rel:.3e} (bound {FP32_TOL}); "
        f"launches {sampled}")
    if got.dtype != torch.float32 or not (np.isfinite(rel) and rel <= FP32_TOL):
        raise AssertionError(f"the fp32 tiny model disagrees with its CPU run: {rel}")

    cpu_ldm = build_latent_diffusion(train_config(tiny=True)["model"], device="cpu", seed=0)
    trainers = [LDMTrainer(ldm=ldm, base_lr=1e-3, use_ema=False)
                for ldm in (cpu_ldm, copy.deepcopy(cpu_ldm).cuda())]
    for trainer in trainers:
        trainer.init_state()
    batch = collate([SyntheticImages(size=128, length=2)[i] for i in range(2)])
    t = torch.from_numpy(np.array([17, 633]))
    noise = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 4, 64, 64)).astype(np.float32))
    want_loss, want = _tiny_loss_and_grads(trainers[0], batch, t, noise, autocast=False)
    reset_launches()
    got_loss, got = _tiny_loss_and_grads(trainers[1], batch, t, noise, autocast=False)
    trained = read_launches()
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    diff = sum((got[n] - want[n]).square().sum() for n in want).sqrt().item()
    norm = sum(want[n].square().sum() for n in want).sqrt().item()
    log(f"[fp32 reference] tiny training step at 128², fp32 outside autocast on the card vs "
        f"the CPU: loss {got_loss:.6f} vs {want_loss:.6f} (relative {loss_rel:.3e}), UNet "
        f"gradients relative L2 {diff / norm:.3e} (bound {FP32_TOL} each); launches "
        f"{trained}")
    if not (loss_rel <= FP32_TOL and diff / norm <= FP32_TOL):
        raise AssertionError("the fp32 training step disagrees with its CPU run")
    for counts in (sampled, trained):
        if any(counts[k] for k in ("flash_attention", "geglu_ff", "flash_attention_bwd")):
            raise AssertionError(f"an fp32 run launched a bf16 kernel: {counts}")


# the small UNet of tests/test_torch_conv_modes.py: every resnet block
# passes K7's gate, and the 32² upsample conv K8's
SMALL_UNET = dict(image_size=32, in_channels=4, out_channels=4, model_channels=128,
                  attention_resolutions=[2], num_res_blocks=1, channel_mult=[1, 2], num_heads=4,
                  use_spatial_transformer=True, transformer_depth=1, context_dim=32)


def check_conv_modes_reference() -> None:
    """The small UNet with both conv modes, bf16 on the card, against the
    same weights in fp32 on the CPU (plain versions)."""
    from sd_tpu_torch.models.unet import UNetConfig, UNetModel
    from sd_tpu_torch.ops.resblock import set_conv_modes
    from sd_tpu_torch.utils.config import init_random_

    cpu = UNetModel(UNetConfig.from_dict(SMALL_UNET)).eval()
    init_random_(cpu, torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to("cuda", torch.bfloat16)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 4, 32, 32)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 8, 32)).astype(np.float32))
    t = torch.tensor([17, 633])
    with torch.no_grad():
        want = cpu(x, t, ctx)
        bf16 = card(x.cuda(), t.cuda(), ctx.cuda()).float().cpu()
        set_conv_modes(card, "1", "winograd")
        reset_launches()
        got = card(x.cuda(), t.cuda(), ctx.cuda()).float().cpu()
        counts = read_launches()
    rel = lambda a: ((a - want).abs().max() / want.abs().max()).item()
    moved = ((got - bf16).norm() / bf16.norm()).item()
    log(f"[conv modes reference] small UNet, both modes in bf16 on the card vs fp32 on the CPU: "
        f"max |diff| / max |ref| = {rel(got):.3e} (bound {CONV_MODES_TOL}); the card's bf16 run "
        f"without the modes {rel(bf16):.3e}, {moved:.3e} (relative L2) from the modes' run; "
        f"launches {counts}")
    if counts["fused_conv3x3"] != 16 or counts["winograd_conv3x3"] != 1:
        raise AssertionError(f"the small UNet did not take K7 16 times and K8 once: {counts}")
    if torch.equal(got, bf16):
        raise AssertionError("the small UNet's output did not change with the conv modes")
    if not (np.isfinite(rel(got)) and rel(got) <= CONV_MODES_TOL):
        raise AssertionError(f"small UNet with the conv modes disagrees: {rel(got)}")


def _counted():
    """Every launch counter: the eleven kernels, K5's "qkpv" share, and the
    int8 conv's calls on the card."""
    from sd_tpu_torch.ops import cuda
    from sd_tpu_torch.ops.quant import int8_conv3x3

    return {**{name: getattr(cuda, name) for name in cuda.COUNTED},
            "int8_conv3x3": int8_conv3x3}


def check_int8_reference() -> None:
    """The tiny model at 256² with every int8 bucket, bf16 on the card,
    against the same weights in fp32 on the CPU without int8."""
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline
    from sd_tpu_torch.pipelines.txt2img import Txt2ImgPipeline

    cpu_pipe, _ = build_txt2img_pipeline(tiny=True, device="cpu", seed=0, watermark=False,
                                          safety=False)
    card_ldm = copy.deepcopy(cpu_pipe.ldm).to(device="cuda", dtype=torch.bfloat16)
    card_pipe = Txt2ImgPipeline(ldm=card_ldm, tokenizer=cpu_pipe.tokenizer,
                                downsample=cpu_pipe.downsample)
    hw = 256
    x_T = np.random.default_rng(0).standard_normal((2, hw // 2, hw // 2, 4)).astype(np.float32)
    run = dict(height=hw, width=hw, steps=5, guidance_scale=7.5)
    prompts = [PROMPT, "a red cube"]
    cpu_pipe(prompts, x_T=torch.from_numpy(x_T), **run)
    want = cpu_pipe.last_latents
    card_pipe(prompts, x_T=torch.from_numpy(x_T).cuda(), **run)
    bf16 = card_pipe.last_latents.cpu()
    card_ldm.set_int8_mode("conv,ff,attn,attn_pv,proj")
    reset_launches()
    card_pipe(prompts, x_T=torch.from_numpy(x_T).cuda(), **run)
    counts = read_launches()
    got = card_pipe.last_latents.cpu()
    rel = lambda a: ((a - want).norm() / want.norm()).item()
    log(f"[int8 reference] tiny model at {hw}², every bucket in bf16 on the card vs fp32 on the "
        f"CPU without int8, PLMS 5: relative L2 {rel(got):.4e} (bound {AGREEMENT_TOL}); the "
        f"card's bf16 run {rel(bf16):.4e}; launches {counts}")
    for k in ("flash_attention_int8", "int8_dense", "int8_conv3x3"):
        if counts[k] == 0:
            raise AssertionError(f"the tiny int8 run did not reach {k}")
    if not (np.isfinite(rel(got)) and rel(got) < AGREEMENT_TOL) or torch.equal(got, bf16):
        raise AssertionError(f"tiny int8 run: relative L2 {rel(got)} (or identical to bf16)")


def reset_launches() -> None:
    for fn in _counted().values():
        fn.launches = 0
    _counted()["flash_attention_int8"].pv_launches = 0


def read_launches() -> dict:
    counts = {k: fn.launches for k, fn in _counted().items()}
    counts["flash_attention_int8_qkpv"] = _counted()["flash_attention_int8"].pv_launches
    return counts


def expect(**nonzero) -> dict:
    """An expected count for every counter: those given, 0 elsewhere."""
    want = dict.fromkeys(read_launches(), 0)
    want.update(nonzero)
    return want


def build_sd_v1(int8: str):
    from sd_tpu_torch.ops.quant import int8_mode_label
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline

    t0 = time.perf_counter()
    pipe, _ = build_txt2img_pipeline(device="cuda", seed=0, watermark=False, int8=int8,
                                     safety=False, fused_conv="auto", conv_impl="auto")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.ldm.parameters())
    label = int8_mode_label(pipe.ldm.int8_mode, "cuda")
    log(f"[serve {label}] SD v1 full width, {n_params / 1e6:.1f}M parameters in bf16, built "
        f"(weights quantized) in {time.perf_counter() - t0:.1f} s")
    return pipe, label


def serve(pipe, label: str, requests: int, batch: int, want: dict) -> dict:
    """``requests`` requests of ``batch`` prompts at 512², PLMS 50, guidance
    7.5, request r drawing from a generator seeded r; the launch counters,
    reset just before, must equal ``want`` times ``requests``. Returns the
    counts, each request's final latents and seconds."""
    log(f"[serve {label}] {requests} request(s) of batch {batch}, 512x512, PLMS {STEPS} steps, "
        f"guidance 7.5 (no cut)")
    latents, seconds = [], []
    reset_launches()
    for r in range(requests):
        gen = torch.Generator(device="cuda").manual_seed(r)
        images = pipe([PROMPT] * batch, gen, height=512, width=512, steps=STEPS,
                      guidance_scale=7.5)
        t = pipe.last_timings
        z = pipe.last_latents
        log(f"[serve {label}] request {r}: {t['total_s']:.3f} s (encode {t['encode_s']:.3f}, "
            f"sample {t['sample_s']:.3f}, decode {t['decode_s']:.3f}); "
            f"{t['sample_s'] * 1e3 / (STEPS + 1):.2f} ms per UNet evaluation (B={2 * batch}); "
            f"{batch / t['total_s']:.3f} images/s")
        if images.shape != (batch, 512, 512, 3) or images.dtype != np.uint8:
            raise AssertionError(f"request {r}: images {images.shape} {images.dtype}")
        if any(img.min() == img.max() for img in images):
            raise AssertionError(f"request {r}: constant image")
        if not torch.isfinite(z).all():
            raise AssertionError(f"request {r}: latents not finite")
        latents.append(z.float().cpu())
        seconds.append(t["total_s"])
    counts = read_launches()
    want = {k: requests * v for k, v in want.items()}
    log(f"[serve {label}] launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    return {"launches": counts, "latents": latents, "seconds": seconds}


def serve_main_path() -> dict:
    pipe, label = build_sd_v1("off")
    out = serve(pipe, label, REQUESTS, 1, expect(
        flash_attention=SITES_PER_UNET * (STEPS + 1) + 1,
        geglu_ff=SITES_PER_UNET * (STEPS + 1)))
    batch8 = serve(pipe, label, 1, BATCH8, expect(
        flash_attention=SITES_PER_UNET * (STEPS + 1) + 1,
        geglu_ff=SITES_PER_UNET * (STEPS + 1)))
    out["batch8_seconds"] = batch8["seconds"][0]
    return out, pipe


def serve_conv_modes(pipe, bf16: dict) -> dict:
    """SD v1 with each conv mode and with both: one request each with the
    bf16 phase's generator 0, exact K7 and K8 counts, K1 and K2 as in bf16,
    latents within AGREEMENT_TOL of the bf16 request 0's."""
    s1 = STEPS + 1
    k7 = 2 * (FUSED_BLOCKS["unet"] * s1 + FUSED_BLOCKS["decoder"])
    k8 = WINO_SITES["unet"] * s1 + WINO_SITES["decoder"]
    k8_beside = WINO_SITES_BESIDE_FUSED["unet"] * s1 + WINO_SITES_BESIDE_FUSED["decoder"]
    runs = (("1", "auto", dict(fused_conv3x3=k7)), ("auto", "winograd", dict(winograd_conv3x3=k8)),
            ("1", "winograd", dict(fused_conv3x3=k7, winograd_conv3x3=k8_beside)))
    total, seconds = {}, []
    z16 = bf16["latents"][0]
    for fused, impl, counts in runs:
        pipe.ldm.set_conv_modes(fused, impl)
        label = f"bf16, SD_TPU_FUSED_CONV={fused}, SD_TPU_CONV_IMPL={impl}"
        out = serve(pipe, label, 1, 1, expect(
            flash_attention=SITES_PER_UNET * s1 + 1, geglu_ff=SITES_PER_UNET * s1, **counts))
        z = out["latents"][0]
        rel = ((z - z16).norm() / z16.norm()).item()
        log(f"[serve {label}] agreement: latents against the bf16 request 0, relative L2 "
            f"{rel:.5f} (bound {AGREEMENT_TOL}); identical: {torch.equal(z, z16)}; "
            f"{out['seconds'][0]:.3f} s against bf16's {bf16['seconds'][0]:.3f} s")
        if not (np.isfinite(rel) and rel < AGREEMENT_TOL) or torch.equal(z, z16):
            raise AssertionError(f"{label} disagrees with bf16: relative L2 {rel}")
        seconds.append(out["seconds"][0])
        for k, v in out["launches"].items():
            total[k] = total.get(k, 0) + v
    pipe.ldm.set_conv_modes("auto", "auto")
    again = serve(pipe, "bf16, after the conv modes", 1, 1, expect(
        flash_attention=SITES_PER_UNET * s1 + 1, geglu_ff=SITES_PER_UNET * s1))
    log(f"[serve] per request: bf16 {' '.join(f'{t:.3f}' for t in bf16['seconds'])} s, then the "
        f"conv modes (fused, winograd, both) {' '.join(f'{t:.3f}' for t in seconds)} s, then "
        f"bf16 {again['seconds'][0]:.3f} s")
    for k, v in again["launches"].items():
        total[k] += v
    return total


def serve_request(pipe, label: str, tower_layers: int, batch: int = 1, seed: int = 0,
                  sampler: str = "dpm", steps: int = DPM_STEPS, **kwargs) -> tuple:
    """One request of ``batch`` prompts at 512², guidance 7.5, through
    ``pipe`` with its safety checker (a tower of ``tower_layers``), drawing
    from a CUDA generator seeded ``seed``; the launch counters, reset just
    before, must show K1 = 16 E + 1 + tower_layers and K2 = 16 E for the
    sampler's E UNet evaluations. Returns (images, counts)."""
    evals = EVALS[sampler](steps)
    reset_launches()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    images = pipe([PROMPT] * batch, gen, height=512, width=512, steps=steps,
                  guidance_scale=7.5, sampler=sampler, **kwargs)
    counts = read_launches()
    t = pipe.last_timings
    log(f"[{label}] batch {batch}: {t['total_s']:.3f} s (encode {t['encode_s']:.3f}, sample "
        f"{t['sample_s']:.3f}, decode {t['decode_s']:.3f}, safety {t['safety_s'] * 1e3:.2f} ms); "
        f"{evals} UNet evaluations, {t['sample_s'] * 1e3 / evals:.2f} ms each (B={2 * batch}); "
        f"{batch / t['total_s']:.3f} images/s; flags {pipe.last_safety_flags}")
    want = expect(flash_attention=SITES_PER_UNET * evals + 1 + tower_layers,
                  geglu_ff=SITES_PER_UNET * evals)
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    if images.shape != (batch, 512, 512, 3) or images.dtype != np.uint8:
        raise AssertionError(f"{label}: images {images.shape} {images.dtype}")
    if any(img.min() == img.max() for img in images):
        raise AssertionError(f"{label}: constant image")
    if not torch.isfinite(pipe.last_latents).all():
        raise AssertionError(f"{label}: latents not finite")
    return images, counts


def add_counts(total: dict, counts: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in counts.items()}


def write_reference_checkpoint(path: str) -> dict:
    """SD v1 at full width in the reference's layout, as sd-v1-4-full-ema.ckpt
    holds it: ``{"state_dict", "global_step"}`` with the model's keys
    (seeded random weights, fp32), an EMA shadow of the UNet under
    ``model_ema.*`` (other random values), ``model_ema.decay`` and
    ``num_updates``, the schedule buffers and CLIP's ``position_ids``.
    Returns the UNet's tensors as written."""
    from sd_tpu_torch.core.schedules import DiffusionSchedule
    from sd_tpu_torch.utils.config import (REFERENCE_EXTRA_KEYS, SD_V1_MODEL_CONFIG,
                                           build_latent_diffusion, init_random_)

    ldm = build_latent_diffusion(SD_V1_MODEL_CONFIG, device="cuda", seed=1)
    sd = {k: v.cpu() for k, v in ldm.state_dict().items()}
    ema = copy.deepcopy(ldm.model.diffusion_model)
    init_random_(ema, torch.Generator(device="cuda").manual_seed(2))
    for k, v in ema.state_dict().items():
        sd["model_ema." + ("diffusion_model." + k).replace(".", "")] = v.cpu()
    del ldm, ema
    sd["model_ema.decay"] = torch.tensor(0.9999)
    sd["model_ema.num_updates"] = torch.tensor(470000, dtype=torch.int32)
    schedule = DiffusionSchedule.create(timesteps=1000, linear_start=0.00085, linear_end=0.012)
    for name in REFERENCE_EXTRA_KEYS:
        if "." not in name:  # the schedule buffers
            sd[name] = torch.from_numpy(getattr(schedule, name))
    sd["cond_stage_model.transformer.text_model.embeddings.position_ids"] = \
        torch.arange(77)[None]
    t0 = time.perf_counter()
    torch.save({"state_dict": sd, "global_step": 470000}, path)
    log(f"[serve ckpt] wrote a reference-layout SD v1 checkpoint, fp32 storage, "
        f"{len(sd)} tensors, {os.path.getsize(path) / 2**30:.2f} GiB in "
        f"{time.perf_counter() - t0:.1f} s")
    return {k[len("model.diffusion_model."):]: v for k, v in sd.items()
            if k.startswith("model.diffusion_model.")}


def write_bpe_vocab(path: str) -> None:
    """A synthetic CLIP merges file (``bpe_simple_vocab_16e6.txt.gz``'s
    format) whose merges make whole tokens of the smoke's prompts' words."""
    from sd_tpu_torch.data.tokenizer import _clean, _clip_pattern, bytes_to_unicode

    enc, merges = bytes_to_unicode(), []
    for word in _clip_pattern().findall(_clean(f"{PROMPT} {NEGATIVE}")):
        symbols = [enc[b] for b in word.encode("utf-8")]
        symbols[-1] += "</w>"
        while len(symbols) > 1:
            if (pair := (symbols[0], symbols[1])) not in merges:
                merges.append(pair)
            symbols = ["".join(pair)] + symbols[2:]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: 0.2"] + [" ".join(m) for m in merges]))


def serve_from_checkpoint() -> dict:
    """[serve ckpt]: SD v1 from a reference-layout checkpoint file (written
    to a temporary directory that goes whether the phase passes or fails)."""
    with tempfile.TemporaryDirectory(prefix="sd_v1_ckpt_") as d:
        return _serve_ckpt(d)


def _serve_ckpt(d: str) -> dict:
    from sd_tpu_torch.models.clip_vision import CLIP_VIT_L_14_VISION
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline
    from sd_tpu_torch.pipelines.safety import SafetyChecker, placeholder_image
    from sd_tpu_torch.utils.config import init_random_

    t_phase = time.perf_counter()
    ckpt = os.path.join(d, "sd-v1.ckpt")
    unet_sd = write_reference_checkpoint(ckpt)
    free_memory()
    write_bpe_vocab(os.path.join(d, "bpe.txt.gz"))
    before = os.environ.get("SD_TPU_BPE_VOCAB")
    os.environ["SD_TPU_BPE_VOCAB"] = os.path.join(d, "bpe.txt.gz")
    try:
        t0 = time.perf_counter()
        pipe, _ = build_txt2img_pipeline(ckpt=ckpt, device="cuda", seed=0, watermark=False)
        torch.cuda.synchronize()
    finally:
        if before is None:
            os.environ.pop("SD_TPU_BPE_VOCAB")
        else:
            os.environ["SD_TPU_BPE_VOCAB"] = before
    load_s = time.perf_counter() - t0
    loaded = pipe.ldm.model.diffusion_model.state_dict()
    bad = [k for k, v in loaded.items()
           if not torch.equal(v, unet_sd[k].to("cuda", torch.bfloat16))]
    log(f"[serve ckpt] built through build_txt2img_pipeline(ckpt=...) in {load_s:.1f} s (the "
        f"file read, SD v1 loaded and cast to bf16, the untrained safety checker, the CLIP "
        f"tokenizer on a synthetic vocabulary); UNet against the file's model.diffusion_model.* "
        f"in bf16: {len(loaded) - len(bad)} of {len(loaded)} tensors equal bit for bit")
    if bad:
        raise AssertionError(f"the loaded UNet differs from the file at {bad[:8]}")
    del unet_sd
    total = {}
    for label, kw in (("DDIM 50, eta 0", dict(sampler="ddim", steps=STEPS)),
                      ("DDIM 50, eta 1", dict(sampler="ddim", steps=STEPS, eta=1.0)),
                      (f"DPM-Solver++ {DPM_STEPS}", dict(sampler="dpm", steps=DPM_STEPS)),
                      ("PLMS 50, negative prompts",
                       dict(sampler="plms", steps=STEPS, negative_prompts=[NEGATIVE]))):
        _, counts = serve_request(pipe, f"serve ckpt] [{label}", UNTRAINED_LAYERS, **kw)
        total = add_counts(total, counts)

    # map_batches against sequential calls with the same generators
    requests = lambda: [dict(prompts=[PROMPT], generator=torch.Generator(
        device="cuda").manual_seed(10 + r), height=512, width=512, steps=DPM_STEPS,
        guidance_scale=7.5, sampler="dpm") for r in range(REQUESTS)]
    t0 = time.perf_counter()
    sequential = [pipe(**req) for req in requests()]
    seq_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    mapped = list(pipe.map_batches(requests(), depth=2))
    map_s = time.perf_counter() - t0
    counts = read_launches()
    equal = [np.array_equal(a, b) for a, b in zip(mapped, sequential)]
    log(f"[serve ckpt] map_batches over {REQUESTS} DPM-Solver++ {DPM_STEPS} requests, depth 2: "
        f"{map_s:.3f} s, {REQUESTS / map_s:.3f} images/s; the same requests one after another "
        f"{seq_s:.3f} s, {REQUESTS / seq_s:.3f} images/s; images equal {equal}")
    evals = EVALS["dpm"](DPM_STEPS)
    want = expect(flash_attention=REQUESTS * (SITES_PER_UNET * evals + 1 + UNTRAINED_LAYERS),
                  geglu_ff=REQUESTS * SITES_PER_UNET * evals)
    if not all(equal) or len(mapped) != REQUESTS or counts != want:
        raise AssertionError(f"map_batches: images equal {equal}, counts {counts} != {want}")
    total = add_counts(total, counts)
    del pipe, sequential, mapped
    free_memory()

    # the checker armed at full width: a synthetic HF-layout ViT-L/14
    # StableDiffusionSafetyChecker state_dict, loaded through safety_ckpt
    checker = SafetyChecker(CLIP_VIT_L_14_VISION).cuda()
    init_random_(checker, torch.Generator(device="cuda").manual_seed(7))
    with torch.no_grad():
        checker.concept_embeds_weights.fill_(2.0)
        checker.special_care_embeds_weights.fill_(2.0)
    safety_ckpt = os.path.join(d, "safety_checker.pt")
    torch.save({k: v.cpu() for k, v in checker.state_dict().items()}, safety_ckpt)
    del checker
    pipe, _ = build_txt2img_pipeline(device="cuda", seed=0, watermark=False,
                                     safety_ckpt=safety_ckpt)
    _, counts = serve_request(pipe, "serve ckpt] [ViT-L/14 checker, unreachable thresholds",
                              VIT_L_LAYERS, batch=2)
    total = add_counts(total, counts)
    if pipe.last_safety_flags != [False, False]:
        raise AssertionError(f"unreachable thresholds flagged {pipe.last_safety_flags}")
    with torch.no_grad():
        pipe.safety_checker.concept_embeds_weights.fill_(-2.0)
        pipe.safety_checker.special_care_embeds_weights.fill_(-2.0)
    images, counts = serve_request(pipe, "serve ckpt] [ViT-L/14 checker, thresholds -2",
                                   VIT_L_LAYERS, batch=2)
    total = add_counts(total, counts)
    placeholder = placeholder_image(512, 512)
    replaced = [np.array_equal(img, placeholder) for img in images]
    if pipe.last_safety_flags != [True, True] or not all(replaced):
        raise AssertionError(f"thresholds -2: flags {pipe.last_safety_flags}, replaced "
                             f"{replaced}")
    log(f"[serve ckpt] thresholds -2: every image flagged and replaced by the placeholder; "
        f"phase {time.perf_counter() - t_phase:.1f} s; launches {total}")
    return total


def serve_from_run(logdir: str) -> dict:
    """[serve run]: SD v1 from the training phase's own run directory (the
    UNet's EMA shadow, the run's config, its frozen stages drawn again from
    the recorded seed), one DPM-Solver++ request with exact counts."""
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline
    from sd_tpu_torch.utils.checkpoint import latest_checkpoint

    t0 = time.perf_counter()
    pipe, _ = build_txt2img_pipeline(ckpt=logdir, device="cuda", seed=0, watermark=False)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    shadow = torch.load(latest_checkpoint(os.path.join(logdir, "checkpoints")),
                        map_location="cpu", weights_only=True, mmap=True)["state"]["ema"]["shadow"]
    params = dict(pipe.ldm.model.diffusion_model.named_parameters())
    bad = [k for k, v in params.items()
           if not torch.equal(v, shadow[k].to("cuda", torch.bfloat16))]
    log(f"[serve run] built through build_txt2img_pipeline(ckpt=<logdir>) in {load_s:.1f} s; "
        f"UNet against the run's EMA shadow in bf16: {len(params) - len(bad)} of "
        f"{len(params)} parameters equal bit for bit")
    if bad or len(shadow) != len(params):
        raise AssertionError(f"the UNet is not the EMA shadow at {bad[:8]}")
    del shadow
    _, counts = serve_request(pipe, "serve run", UNTRAINED_LAYERS)
    log(f"[serve run] {time.perf_counter() - t0:.1f} s")
    return counts


def img2img_main_path() -> dict:
    """[img2img]: SD v1 at full width in bf16 through Img2ImgPipeline from a
    synthetic 512² init image, batch 1, DDIM 50, guidance 7.5: at strength
    0.75 (t_enc 37) K1 = 16 t_enc + 2 (the encoder's and the decoder's
    mid-blocks) and K2 = 16 t_enc; at strength 0 K1 = 2 and K2 = 0. Then
    the CLI's main() once, from a PNG in a temporary directory, DDIM 10."""
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline
    from sd_tpu_torch.pipelines.img2img import Img2ImgPipeline
    from sd_tpu_torch.scripts import img2img as cli
    from sd_tpu_torch.utils.image import load_image, save_image

    t_phase = time.perf_counter()
    base, _ = build_txt2img_pipeline(device="cuda", seed=0, watermark=False, safety=False)
    pipe = Img2ImgPipeline(base)
    init = synthetic_image(512, seed=0)
    total = {}

    def check(label, t_enc, counts, images, latents):
        want = expect(flash_attention=SITES_PER_UNET * t_enc + 2,
                      geglu_ff=SITES_PER_UNET * t_enc)
        if counts != want:
            raise AssertionError(f"[img2img] {label}: launch counts {counts} != {want}")
        if images.shape != (1, 512, 512, 3) or images.dtype != np.uint8:
            raise AssertionError(f"[img2img] {label}: images {images.shape} {images.dtype}")
        if images.min() == images.max() or not torch.isfinite(latents).all():
            raise AssertionError(f"[img2img] {label}: constant image or latents not finite")

    for strength in (0.75, 0.0):
        t_enc = int(strength * STEPS)
        reset_launches()
        images = pipe(init, [PROMPT], torch.Generator(device="cuda").manual_seed(0),
                      strength=strength, steps=STEPS, guidance_scale=7.5)
        counts = read_launches()
        t = pipe.last_timings
        log(f"[img2img] SD v1, 512², strength {strength}, DDIM {STEPS} (t_enc {t_enc}), "
            f"guidance 7.5, batch 1: {t['total_s']:.3f} s (encode {t['encode_s']:.3f}, sample "
            f"{t['sample_s']:.3f}, decode {t['decode_s']:.3f}); launches {counts}")
        check(f"strength {strength}", t_enc, counts, images, pipe.last_latents)
        total = add_counts(total, counts)
    del pipe, base
    free_memory()

    with tempfile.TemporaryDirectory(prefix="img2img_cli_") as d:
        save_image(init, os.path.join(d, "init.png"))
        out = os.path.join(d, "out")
        reset_launches()
        t0 = time.perf_counter()
        cli.main(["--init-img", os.path.join(d, "init.png"), "--outdir", out,
                  "--ddim_steps", "10", "--prompt", PROMPT])
        counts = read_launches()
        names = sorted(os.listdir(out))
        log(f"[img2img] the CLI's main(), DDIM 10 at strength 0.75 (build included): "
            f"{time.perf_counter() - t0:.1f} s, wrote {names}; launches {counts}")
        if names != ["00000.png"]:
            raise AssertionError(f"[img2img] the CLI wrote {names}")
        written = load_image(os.path.join(out, "00000.png"))
        check("CLI", int(0.75 * 10), counts, written[None], torch.zeros(1))
        total = add_counts(total, counts)
    free_memory()
    log(f"[img2img] phase {time.perf_counter() - t_phase:.1f} s; launches {total}")
    return total


def serve_daemon() -> dict:
    """[serve daemon]: sd_tpu_torch.scripts.serve's Server in this process,
    its outputs in a temporary directory that goes whether the phase passes
    or fails, its worker stopped at the end."""
    import io

    from sd_tpu_torch.scripts import serve as daemon

    with tempfile.TemporaryDirectory(prefix="serve_daemon_") as outdir:
        opt = daemon.parse_args(
            ["--sampler", "dpm", "--steps", str(DPM_STEPS), "--max-batch", "2", "--bucket",
             f"256x256@{DPM_STEPS}", "--batch-window", "500", "--no-watermark", "--outdir",
             outdir])
        t0 = time.perf_counter()
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            server = daemon.Server(opt)
        for line in err.getvalue().splitlines():
            log(f"[serve daemon] {line}")
        log(f"[serve daemon] SD v1 built and both buckets warm in {time.perf_counter() - t0:.1f}"
            f" s; {server.effective_config()}")
        try:
            return _serve_daemon(server, daemon)
        finally:
            server.close()


def _serve_daemon(server, daemon) -> dict:
    import threading
    import urllib.request

    from sd_tpu_torch.utils.image import load_image

    t_phase = time.perf_counter()
    evals = EVALS["dpm"](DPM_STEPS)
    reset_launches()

    def request(req: dict) -> dict:
        t0 = time.perf_counter()
        resp = server.handle(req)
        resp["client_s"] = time.perf_counter() - t0
        if not resp.get("ok"):
            raise AssertionError(f"[serve daemon] {req} answered {resp}")
        return resp

    alone = [request({"prompt": PROMPT, "seed": s}) for s in range(REQUESTS)]
    alone.append(request({"prompt": "a red cube", "seed": 7}))
    seconds = [r["seconds"] for r in alone]
    client = [r["client_s"] for r in alone]
    log(f"[serve daemon] {len(alone)} one-prompt requests in turn (each padded to batch 2, "
        f"waiting out the 500 ms window), DPM-Solver++ {DPM_STEPS} at 512²: execution "
        f"{' '.join(f'{x:.3f}' for x in seconds)} s (median {np.median(seconds):.3f}, max "
        f"{max(seconds):.3f}); client {' '.join(f'{x:.3f}' for x in client)} s (median "
        f"{np.median(client):.3f}, max {max(client):.3f})")

    # two requests from threads, the second the same (prompt, seed) as the
    # last one served alone
    pair = [None, None]
    threads = [threading.Thread(target=lambda i=i, req=req: pair.__setitem__(i, request(req)))
               for i, req in enumerate(({"prompt": PROMPT, "seed": 3},
                                        {"prompt": "a red cube", "seed": 7}))]
    threads[0].start()
    time.sleep(0.1)
    threads[1].start()
    for th in threads:
        th.join()
    if None in pair:
        raise AssertionError(f"[serve daemon] a coalesced request failed: {pair}")
    shared = pair[0]["exec_id"] == pair[1]["exec_id"]
    batched = [r["batched_requests"] for r in pair]
    same = load_image(pair[1]["paths"][0]).astype(int)
    ref = load_image(alone[-1]["paths"][0]).astype(int)
    max_diff = int(np.abs(same - ref).max())
    log(f"[serve daemon] two requests from threads: exec_id {pair[0]['exec_id']} and "
        f"{pair[1]['exec_id']}, batched_requests {batched}, execution {pair[0]['seconds']:.3f} "
        f"s, client {pair[0]['client_s']:.3f} and {pair[1]['client_s']:.3f} s; the (prompt, "
        f"seed) served alone in slot 0 and coalesced in slot 1: PNGs "
        f"{'equal bit for bit' if max_diff == 0 else f'differ by up to {max_diff}/255'}")
    if not shared or batched != [2, 2]:
        raise AssertionError(f"[serve daemon] the pair did not share an execution: {pair}")
    if max_diff:
        raise AssertionError(f"[serve daemon] the same (prompt, seed) differs by {max_diff}/255")

    small = request({"prompt": PROMPT, "seed": 5, "height": 256, "width": 256})
    if load_image(small["paths"][0]).shape != (256, 256, 3):
        raise AssertionError(f"[serve daemon] the 256² bucket wrote {small['paths']}")
    for req, why in (({"prompt": PROMPT, "steps": 7}, "no warm bucket"),
                     ({"prompt": PROMPT, "eta": 1.0}, "unsupported request fields")):
        resp = server.handle(req)
        if resp.get("ok") is not False or why not in resp.get("error", ""):
            raise AssertionError(f"[serve daemon] {req} was not refused: {resp}")
    log(f"[serve daemon] 256² bucket: execution {small['seconds']:.3f} s; a cold bucket and an "
        f"unknown field refused")

    httpd = daemon.http_server(server, 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/txt2img"
        body = json.dumps({"prompt": PROMPT, "seed": 9}).encode()
        t0 = time.perf_counter()
        with urllib.request.urlopen(urllib.request.Request(
                url, data=body, headers={"Content-Type": "application/json"}), timeout=300) as r:
            resp = json.loads(r.read())
        http_s = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
    if not resp.get("ok") or resp["safety_flagged"] != [False]:
        raise AssertionError(f"[serve daemon] HTTP answered {resp}")
    log(f"[serve daemon] HTTP POST /txt2img on 127.0.0.1: {http_s:.3f} s round trip, "
        f"execution {resp['seconds']:.3f} s")

    counts = read_launches()
    execs = server.exec_count
    per_exec = dict(flash_attention=SITES_PER_UNET * evals + 1 + UNTRAINED_LAYERS,
                    geglu_ff=SITES_PER_UNET * evals)
    want = expect(**{k: execs * v for k, v in per_exec.items()})
    log(f"[serve daemon] {execs} executions; launches {counts}, expected {per_exec} each; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    if execs != len(alone) + 3 or counts != want:
        raise AssertionError(f"[serve daemon] {execs} executions, launches {counts} != {want}")
    check_conv_slots(server.pipe, daemon.without_cudnn)
    return counts


@contextlib.contextmanager
def cudnn_flag(name: str, value: bool):
    """``torch.backends.cudnn.<name>`` set to ``value`` within the block."""
    saved = getattr(torch.backends.cudnn, name)
    setattr(torch.backends.cudnn, name, value)
    try:
        yield
    finally:
        setattr(torch.backends.cudnn, name, saved)


def check_conv_slots(pipe, without_cudnn) -> None:
    """Why the daemon runs without cuDNN where requests share an execution:
    one SD v1 UNet evaluation in bf16 on a batch of two and on it with its
    rows swapped, under cuDNN as it is, with ``deterministic``, with
    ``benchmark`` and without cuDNN (each row's output must not depend on
    its slot there); then the ms of a UNet evaluation (CUDA events, 10
    after 3) at B=2 (the daemon's batch at --max-batch 1, where it keeps
    cuDNN), B=4 (its padded batch of 2 with guidance) and B=16, with and
    without cuDNN in turns. Not counted: these launches compare, they serve
    nothing."""
    unet = pipe.ldm.model.diffusion_model
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 4, 64, 64), generator=gen).cuda()
    t = torch.tensor([500, 500], device="cuda")
    scopes = {"cuDNN": contextlib.nullcontext,
              "deterministic": lambda: cudnn_flag("deterministic", True),
              "benchmark": lambda: cudnn_flag("benchmark", True),
              "without cuDNN": without_cudnn}
    with torch.inference_mode():
        ctx = pipe.encode_prompts([PROMPT, "a red cube"])
        diff = {}
        for label, scope in scopes.items():
            with scope():
                a, b = unet(x, t, ctx), unet(x.flip(0), t, ctx.flip(0)).flip(0)
            diff[label] = (a.float() - b.float()).abs().max().item()
        ms = {}
        for batch in (1, 2, 8):
            xb, tb = x.repeat(batch, 1, 1, 1), t.repeat(batch)
            cb = ctx.repeat(batch, 1, 1)
            for label in ("cuDNN", "without cuDNN", "without cuDNN", "cuDNN"):
                with scopes[label]():
                    ms.setdefault((2 * batch, label), []).append(
                        time_ms(lambda: unet(xb, tb, cb), iters=10))
    log(f"[serve daemon] one UNet evaluation, rows swapped: max |diff| of a row's output "
        + ", ".join(f"{v:.3e} {label}" for label, v in diff.items())
        + "; ms per evaluation (in turns): " + "; ".join(
            f"B={b} {label} {' '.join(f'{v:.2f}' for v in vals)}"
            for (b, label), vals in ms.items()))
    if diff["without cuDNN"] != 0:
        raise AssertionError(f"without cuDNN a row's output depends on its slot: {diff}")


class _Timed:
    """A callable with each call's seconds (on the card, synchronised) and
    launches recorded in ``calls``; its other attributes pass through."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __call__(self, *args, **kwargs):
        before, t0 = read_launches(), time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        after = read_launches()
        self.calls.append({"s": time.perf_counter() - t0, "out": out,
                           "launches": {k: after[k] - before[k] for k in after}})
        return out


def conv3x3_calls(ldm) -> int:
    """int8 conv calls per request: each Conv3x3 of the UNet once per UNet
    evaluation, each of the decoder once."""
    from sd_tpu_torch.ops.conv import Conv3x3

    n = lambda m: sum(isinstance(x, Conv3x3) for x in m.modules())
    return n(ldm.model.diffusion_model) * (STEPS + 1) + n(ldm.first_stage_model.decoder)


def serve_int8(bf16: dict) -> dict:
    """The int8 serving mode at SD v1 full width: "all" at batch 1 with the
    agreement gate, every bucket, and "all" at batch 8."""
    from sd_tpu_torch.scripts.int8_quality import check_agreement

    s1 = STEPS + 1
    pipe, label = build_sd_v1("all")
    convs = conv3x3_calls(pipe.ldm)
    int8 = serve(pipe, label, REQUESTS, 1, expect(
        flash_attention_int8=5 * s1 + 1, flash_attention=11 * s1, geglu_ff_int8=5 * s1,
        geglu_ff=11 * s1, int8_conv3x3=convs))
    # int8_quality --flagship's gate, on request 0's latents
    check_agreement(f"serve {label}", int8["latents"][0], bf16["latents"][0],
                    versus="the bf16 request 0")

    batch8 = serve(pipe, label, 1, BATCH8, expect(
        flash_attention_int8=5 * s1 + 1, flash_attention=11 * s1, geglu_ff_int8=11 * s1,
        geglu_ff=5 * s1, int8_conv3x3=convs))
    log(f"[serve] batch {BATCH8}: int8 {BATCH8 / batch8['seconds'][0]:.3f} images/s, bf16 "
        f"{BATCH8 / bf16['batch8_seconds']:.3f} images/s")

    pipe.ldm.set_int8_mode("conv,ff,attn,attn_pv,proj")
    every = serve(pipe, "bf16+int8[every bucket]", 1, 1, expect(
        flash_attention_int8=5 * s1 + 1, flash_attention_int8_qkpv=1, flash_attention=11 * s1,
        geglu_ff_int8=5 * s1, geglu_ff=11 * s1, int8_dense=4 * SITES_PER_UNET * s1,
        int8_conv3x3=convs))
    total = {k: int8["launches"][k] + batch8["launches"][k] + every["launches"][k]
             for k in int8["launches"]}
    return total


def _tiny_loss_and_grads(trainer, batch, t, noise, autocast: bool = True):
    """One loss of ``p_losses`` and the UNet gradients, with the batch's
    latents at the posterior's mode and the given t and noise; under the
    trainer's autocast, or outside any."""
    from sd_tpu_torch.training.diffusion_loss import p_losses

    ldm, device = trainer.ldm, trainer.device
    scope = trainer.autocast if autocast else contextlib.nullcontext
    x = torch.from_numpy(batch["image"]).to(device).permute(0, 3, 1, 2)
    tokens = torch.from_numpy(batch["caption"]).to(device).long()
    trainer.unet.zero_grad(set_to_none=True)
    with torch.no_grad(), scope():
        z = ldm.encode_to_latent(x).float()
        cond = ldm.get_learned_conditioning(tokens)
    with scope():
        loss, _ = p_losses(ldm.apply_model, ldm.schedule, z, cond, t.to(device),
                           noise.to(device))
    loss.backward()
    return loss.item(), {n: p.grad.float().cpu() for n, p in trainer.unet.named_parameters()}


def check_training_reference() -> None:
    from sd_tpu_torch.data.synthetic import SyntheticImages
    from sd_tpu_torch.data.base import collate
    from sd_tpu_torch.training.diffusion_loss import create_train_state
    from sd_tpu_torch.utils.config import build_latent_diffusion, train_config

    model_cfg = train_config(tiny=True)["model"]
    cpu_ldm = build_latent_diffusion(model_cfg, device="cpu", seed=0)
    card_ldm = copy.deepcopy(cpu_ldm).cuda()
    cpu_trainer, _ = create_train_state(cpu_ldm, 1e-3, use_ema=False)
    card_trainer, card_state = create_train_state(card_ldm, 1e-3, use_ema=False)
    batch = collate([SyntheticImages(size=128, length=2)[i] for i in range(2)])
    rng = np.random.default_rng(0)
    t = torch.from_numpy(np.array([17, 633]))
    noise = torch.from_numpy(rng.standard_normal((2, 4, 64, 64)).astype(np.float32))

    want_loss, want = _tiny_loss_and_grads(cpu_trainer, batch, t, noise)
    reset_launches()
    got_loss, got = _tiny_loss_and_grads(card_trainer, batch, t, noise)
    launches = read_launches()
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    diff = sum((got[n] - want[n]).square().sum() for n in want).sqrt().item()
    norm = sum(want[n].square().sum() for n in want).sqrt().item()
    # each tensor's error over its allowance (<= 1 passes)
    score = {n: ((got[n] - want[n]).norm()
                 / (TRAIN_TENSOR_TOL * want[n].norm() + TRAIN_TENSOR_FLOOR * norm)).item()
             for n in want}
    worst = max(score, key=score.get)
    negligible = sum(want[n].norm().item() < 1e-6 * norm for n in want)
    log(f"[train reference] tiny model at 128², bf16 autocast card vs fp32 CPU: loss "
        f"{got_loss:.6f} vs {want_loss:.6f} (relative {loss_rel:.3e}, bound {TRAIN_LOSS_TOL}); "
        f"UNet gradients relative L2 {diff / norm:.3e} (bound {TRAIN_GRAD_TOL}); worst tensor "
        f"{worst} at {score[worst]:.3e} of its bound; {negligible} of {len(want)} tensors with a "
        f"reference gradient below 1e-6 of the whole; launches {launches}")
    if launches["flash_attention_bwd"] == 0:
        raise AssertionError("the tiny training step did not reach K3")
    if not (loss_rel <= TRAIN_LOSS_TOL and diff / norm <= TRAIN_GRAD_TOL and score[worst] <= 1):
        raise AssertionError("tiny training step disagrees with its fp32 CPU reference")

    # 20 constant-LR steps on one fixed batch, with the same draws every step
    losses = []
    for _ in range(20):
        gen = torch.Generator("cuda").manual_seed(0)
        losses.append(float(card_trainer.train_step(card_state, batch, gen)["loss"]))
    log(f"[train reference] 20 steps on one batch, AdamW at 1e-3: loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}")
    if not (np.all(np.isfinite(losses)) and np.mean(losses[-5:]) < 0.8 * losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")


def train_main_path() -> tuple:
    """Training, then [serve run] from the run's checkpoint once the trainer
    is freed. Trainer.fit saves last.pt on exit (about 14 GB at this width
    with the EMA shadow): the directory goes whether the phase passes or
    fails."""
    with tempfile.TemporaryDirectory(prefix="sd_v1_train_") as logdir:
        trained = _train(logdir)
        free_memory()
        return trained, serve_from_run(logdir)


def _train(logdir: str) -> dict:
    from sd_tpu_torch.scripts.train import build_trainer, parse_args
    from sd_tpu_torch.training import trainer as trainer_module
    from sd_tpu_torch.training.ema import ema_init
    from sd_tpu_torch.utils.checkpoint import latest_checkpoint

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    harness, state, data = build_trainer(parse_args(
        ["--max_steps", str(TRAIN_STEPS), "--logdir", logdir, "--seed", "0", "--log_every", "1",
         "--ckpt_every", str(10 * TRAIN_STEPS), "--val_every", str(TRAIN_STEPS)]))
    # the hooks fire once, after the last step: the image logger at that
    # step only, validation (and the monitored save) every TRAIN_STEPS
    harness.image_logger = _Timed(trainer_module.ImageLogger(logdir, every=TRAIN_STEPS,
                                                             log_first_n=False))
    harness.validate = _Timed(harness.validate)
    unet = state.unet
    # SD v1's config trains without EMA (use_ema: False); this run keeps the
    # shadow, so that [serve run] samples from it as a released model would
    state.ema = ema_init(dict(unet.named_parameters()))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in unet.parameters())
    batch = data.batch_size
    log(f"[train] SD v1 full width, {n_params / 1e6:.1f}M UNet parameters in fp32 (AdamW, "
        f"bf16 autocast, use_checkpoint {unet.config.use_checkpoint}), frozen kl-f8 encoder and "
        f"CLIP in bf16; batch {batch} of 512² images, 77-token captions; built in "
        f"{time.perf_counter() - t0:.1f} s; {TRAIN_STEPS} steps (no cut)")
    named = dict(unet.named_parameters())
    for site in ("attn1.to_q", "attn1.to_k", "attn1.to_v", "ff.net.0.proj"):
        if not any(site in n for n in named):
            raise AssertionError(f"no UNet parameter named *{site}*")
    times = []
    last = {"t": time.perf_counter(), "launches": read_launches()}
    train_step = harness.trainer_obj.train_step

    def checked_step(state_, batch_, generator):
        """The trainer's step, then this phase's checks of it."""
        aux = train_step(state_, batch_, generator)
        torch.cuda.synchronize()
        now = time.perf_counter()
        step = state_.step
        launches = read_launches()
        delta = {k: launches[k] - last["launches"][k] for k in launches}
        times.append(now - last["t"])
        loss = float(aux["loss"])
        bad = [n for n, p in named.items()
               if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.any()]
        log(f"[train] step {step}: loss {loss:.5f}, {times[-1] * 1e3:.1f} ms, launches {delta}, "
            f"parameters without a finite non-zero gradient: {len(bad)} of {len(named)}")
        if not np.isfinite(loss):
            raise AssertionError(f"step {step}: loss {loss}")
        if bad:
            raise AssertionError(f"step {step}: no finite non-zero gradient on {bad[:8]}")
        if delta != expect(**TRAIN_LAUNCHES):
            raise AssertionError(f"step {step}: launches {delta} != {TRAIN_LAUNCHES}")
        last["t"] = time.perf_counter()
        last["launches"] = launches
        return aux

    harness.trainer_obj.train_step = checked_step
    monitored_save = _Timed(trainer_module.save_monitored)
    trainer_module.save_monitored = monitored_save
    reset_launches()
    last["launches"] = read_launches()
    last["t"] = time.perf_counter()
    try:
        harness.fit(state, data)
    finally:
        trainer_module.save_monitored = monitored_save.fn
    # after the last step fit logs images, validates (with the monitored
    # save) and saves last.pt
    logger, validation = harness.image_logger.calls, harness.validate.calls
    hooks_s = sum(c["s"] for c in logger + validation)
    save_s = time.perf_counter() - last["t"] - hooks_s
    launches = read_launches()
    ckpt = latest_checkpoint(harness.ckpt_dir)
    if ckpt is None:
        raise AssertionError("Trainer.fit saved no checkpoint on exit")
    log(f"[train] save on exit: {save_s:.2f} s, {os.path.getsize(ckpt) / 2**30:.2f} GiB")
    check_training_hooks(harness, data, logger, validation, monitored_save.calls)
    moments = state.optimizer.state
    flat = [n for n, p in named.items()
            if not (moments[p]["exp_avg"].any() and moments[p]["exp_avg_sq"].any())]
    if flat:
        raise AssertionError(f"AdamW moments zero on {flat[:8]}")
    steady = times[1:]
    ms = 1e3 * float(np.median(steady))
    log(f"[train] {TRAIN_STEPS} steps: {' '.join(f'{t * 1e3:.1f}' for t in times)} ms; median of "
        f"steps 2-{TRAIN_STEPS} {ms:.1f} ms per step, {batch / ms * 1e3:.3f} images/s; peak "
        f"memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; AdamW moments "
        f"non-zero on all {len(named)} parameters; launches {launches}")
    check_ema_validation(harness, state, data, validation[0]["out"])
    return launches


def check_ema_validation(harness, state, data, metrics: dict) -> None:
    """Validation's two losses recomputed from its draws, each loss in an
    autocast context of its own: the current UNet's, then the UNet's with
    the EMA shadow copied into its parameters (which it keeps: the phase is
    over). ``val/loss_simple_ema`` must be the shadow's loss within
    ``EMA_VAL_TOL`` of it, not a mix with autocast's cached casts of the
    current weights. Not counted: these launches check, they train nothing."""
    from sd_tpu_torch.training.trainer import VAL_BATCHES, VAL_STREAM

    trainer_obj, unet = harness.trainer_obj, harness.trainer_obj.unet
    batches = list(itertools.islice(data.val_dataloader(), VAL_BATCHES))

    def val_loss() -> float:
        unet.eval()
        with torch.no_grad():
            losses = [trainer_obj.loss_fn(b, harness._generator(state.step, VAL_STREAM + i))[0]
                      for i, b in enumerate(batches)]
        unet.train()
        return float(np.mean(torch.stack(losses).float().cpu().numpy()))

    current = val_loss()
    with torch.no_grad():
        for name, p in unet.named_parameters():
            p.copy_(state.ema.shadow[name])
    ema = val_loss()
    got = metrics["val/loss_simple_ema"]
    log(f"[train] validation recomputed in fresh autocast contexts: current weights {current!r} "
        f"(validation's {metrics['val/loss_simple']!r}), EMA shadow {ema!r} (validation's "
        f"{got!r}); the shadow's loss {abs(ema - current):.3e} from the current weights'")
    if abs(got - ema) > EMA_VAL_TOL * abs(ema):
        raise AssertionError(f"val/loss_simple_ema {got!r} is not the EMA shadow's loss {ema!r}")


def check_training_hooks(harness, data, logger: list, validation: list, saves: list) -> None:
    """The image logger and validation after the training phase's last
    step: one call each; the logger's PNG set (K1 = 16 x 20 + 9: the
    encode, the reconstruction, six diffusion-row decodes and the samples'
    decode; K2 = 16 x 20, DDIM 20 without guidance); validation over V
    batches (K1 = 2V (16 + 1) and K2 = 2V x 16 for its losses with the
    current UNet and the EMA shadow, K3 = 0), both metrics finite, and the
    one monitored checkpoint kept beside last.pt."""
    n_val = min(len(data.val_dataloader()), 8)
    log_want = expect(flash_attention=SITES_PER_UNET * 20 + 9, geglu_ff=SITES_PER_UNET * 20)
    val_want = expect(flash_attention=2 * n_val * (SITES_PER_UNET + 1),
                      geglu_ff=2 * n_val * SITES_PER_UNET)
    if len(logger) != 1 or len(validation) != 1 or len(saves) != 1:
        raise AssertionError(f"hooks called {len(logger)}, {len(validation)} and {len(saves)} "
                             f"times, not once each")
    images = sorted(os.listdir(os.path.join(harness.logdir, "images")))
    step = f"step{TRAIN_STEPS:08}"
    want_images = sorted(f"train_{n}_{step}.png"
                         for n in ("inputs", "reconstruction", "diffusion_row", "samples"))
    metrics = validation[0]["out"]
    ckpts = sorted(os.listdir(harness.ckpt_dir))
    log(f"[train] image logger at step {TRAIN_STEPS}: {logger[0]['s']:.2f} s, wrote {images}; "
        f"launches {logger[0]['launches']}")
    log(f"[train] validation over {n_val} batches at step {TRAIN_STEPS}: "
        f"{validation[0]['s'] - saves[0]['s']:.2f} s, {metrics}; launches "
        f"{validation[0]['launches']}; monitored save ({harness.monitor}) {saves[0]['s']:.2f} s; "
        f"checkpoints {ckpts}")
    if images != want_images or logger[0]["launches"] != log_want:
        raise AssertionError(f"image logger: {images}, launches {logger[0]['launches']} != "
                             f"{log_want}")
    if (set(metrics) != {"val/loss_simple", "val/loss_simple_ema"}
            or not all(np.isfinite(v) for v in metrics.values())
            or validation[0]["launches"] != val_want):
        raise AssertionError(f"validation: {metrics}, launches {validation[0]['launches']} != "
                             f"{val_want}")
    if ckpts != ["last.pt", f"step_{TRAIN_STEPS}.pt"]:
        raise AssertionError(f"checkpoints {ckpts}")


def first_stage_main_path() -> dict:
    """VAE-GAN training of the kl-f8 autoencoder at full width through the
    training CLI's --base path. Trainer.fit's save on exit goes to a
    temporary directory, removed whether the phase passes or fails."""
    with tempfile.TemporaryDirectory(prefix="kl_f8_train_") as logdir:
        return _train_first_stage(logdir)


def _vae_gan_losses(aux: dict) -> dict:
    """A VAE-GAN step's losses: the KL model's or the VQ model's."""
    reg = ("quant_loss", "perplexity", "cluster_usage") if "quant_loss" in aux else ("kl_loss",)
    return {k: float(aux[k]) for k in ("rec_loss", "nll_loss", *reg, "g_loss", "d_weight",
                                       "disc_loss")}


def first_stage_argv(logdir: str) -> list:
    """The training CLI's arguments of the first-stage phase."""
    return ["--base", FIRST_STAGE_CONFIG, "-t", "--logdir", logdir, "--seed", "0",
            "--max_steps", str(FIRST_STAGE_STEPS), "--log_every", "1", "--no_images",
            "model.params.lossconfig.params.disc_start=1"]


def first_stage_grads(ae) -> dict:
    """The gradients the last generator step left, each of
    FIRST_STAGE_GRAD_GROUPS flattened into one fp32 vector."""
    named = list(ae.named_parameters())
    return {g: torch.cat([p.grad.detach().float().flatten() for n, p in named
                          if n.startswith(g + ".")]) for g in FIRST_STAGE_GRAD_GROUPS}


@contextlib.contextmanager
def plain_attention(plain: bool = True):
    """Within the block, with ``plain``, every self-attention call that would
    reach K1 (with K3 behind it) takes ``flash_attention_plain`` instead:
    the same function, no kernel."""
    from sd_tpu_torch.ops import attention
    from sd_tpu_torch.ops.cuda import flash_attention_plain

    kernel_attention = attention.differentiable_flash_attention
    if plain:
        attention.differentiable_flash_attention = (
            lambda q, k, v, scale=None: flash_attention_plain(q, k, v, scale))
    try:
        yield
    finally:
        attention.differentiable_flash_attention = kernel_attention


@contextlib.contextmanager
def plain_kernels():
    """Within the block every call that would reach K1 or K2 takes its plain
    version (``flash_attention_plain``, ``geglu_ff_plain``)."""
    from sd_tpu_torch.ops import attention
    from sd_tpu_torch.ops.cuda import geglu_ff_plain

    kernel_ff = attention.differentiable_geglu_ff
    attention.differentiable_geglu_ff = geglu_ff_plain
    try:
        with plain_attention():
            yield
    finally:
        attention.differentiable_geglu_ff = kernel_ff


def first_stage_steps(argv: list, steps: int, plain: bool) -> tuple:
    """The CLI's first-stage trainer for ``argv``, its first ``steps``
    steps by ``train_step`` with fit's generators; with ``plain``, the
    autograd attention through ``flash_attention_plain``. Returns each
    step's losses and, for a KL model, step 1's gradients
    (FIRST_STAGE_GRAD_GROUPS)."""
    from sd_tpu_torch.scripts.train import build_trainer, parse_args
    from sd_tpu_torch.training.trainer import step_seed

    opt = parse_args(argv)
    harness, state, data = build_trainer(opt)
    losses, grads = [], None
    with plain_attention(plain):
        for step in range(steps):
            generator = torch.Generator("cuda").manual_seed(step_seed(opt.seed, step))
            losses.append(_vae_gan_losses(harness.trainer_obj.train_step(
                state, data.train_dataloader().batch(step), generator)))
            if step == 0 and "kl_loss" in losses[0]:
                grads = first_stage_grads(state.ae)
    del harness, state, data
    free_memory()
    return losses, grads


def first_stage_gaps(losses: list, grads: dict, ref_losses: list, ref_grads: dict) -> dict:
    """{what: (relative gap, its bound)} of the kernels' run against the
    plain attention's: FIRST_STAGE_COMPARED at each step, the gradient
    groups at step 1."""
    gaps = {}
    for step, (got, ref) in enumerate(zip(losses, ref_losses), 1):
        for k in FIRST_STAGE_COMPARED:
            gaps[f"step {step} {k}"] = (abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12),
                                        FIRST_STAGE_LOSS_TOL)
    for g in FIRST_STAGE_GRAD_GROUPS:
        gap = float((grads[g] - ref_grads[g]).norm() / ref_grads[g].norm())
        gaps[f"step 1 grad {g}"] = (gap, FIRST_STAGE_GRAD_TOL)
    return gaps


def check_first_stage_gaps(gaps: dict) -> None:
    """Logs every gap; raises CheckFailed at the worst (gap over bound)
    where one exceeds its bound or is not finite."""
    margin = lambda item: item[1][0] / item[1][1] if np.isfinite(item[1][0]) else np.inf
    log("[first stage] against the plain attention (relative gap, bound): " + ", ".join(
        f"{k} {gap:.3e} ({tol})" for k, (gap, tol) in gaps.items()))
    worst, (gap, tol) = max(gaps.items(), key=margin)
    log(f"[first stage] worst: {worst} {gap:.3e} against {tol}")
    if not gap <= tol:
        raise CheckFailed(f"first stage: {worst} {gap} above {tol}", gap, tol)


def _train_first_stage(logdir: str) -> dict:
    argv = first_stage_argv(logdir)
    # the plain attention's first two steps, from a build of the same seed:
    # the same weights, batches and posterior noise
    ref_losses, ref_grads = first_stage_steps(argv, 2, plain=True)
    from sd_tpu_torch.scripts.train import build_trainer, parse_args

    t0 = time.perf_counter()
    harness, state, data = build_trainer(parse_args(argv))
    trainer = harness.trainer_obj
    n_params = sum(p.numel() for p in state.ae.parameters())
    log(f"[first stage] kl-f8 VAE-GAN ({FIRST_STAGE_CONFIG}, disc_start=1 by dotlist), "
        f"{n_params / 1e6:.1f}M autoencoder parameters in fp32 (Adam, bf16 autocast), batch "
        f"{data.batch_size} of 256² images; built in {time.perf_counter() - t0:.1f} s; "
        f"{FIRST_STAGE_STEPS} steps (no cut)")
    got, times, grads = [], [], {}
    last = {"t": time.perf_counter(), "launches": read_launches()}
    train_step = trainer.train_step

    def checked_step(state_, batch_, generator):
        aux = train_step(state_, batch_, generator)
        torch.cuda.synchronize()
        launches = read_launches()
        delta = {k: launches[k] - last["launches"][k] for k in launches}
        times.append(time.perf_counter() - last["t"])
        losses = _vae_gan_losses(aux)
        got.append(losses)
        if state_.step == 1:
            grads.update(first_stage_grads(state_.ae))
        log(f"[first stage] step {state_.step}: {losses}, disc_factor "
            f"{float(aux['disc_factor'])}, logvar {float(aux['logvar']):.6f}, "
            f"{times[-1] * 1e3:.1f} ms, launches {delta}")
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"first-stage step {state_.step}: {losses}")
        if delta != expect(**FIRST_STAGE_LAUNCHES):
            raise AssertionError(f"first-stage step {state_.step}: launches {delta} != "
                                 f"{FIRST_STAGE_LAUNCHES}")
        last["t"] = time.perf_counter()
        last["launches"] = launches
        return aux

    trainer.train_step = checked_step
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    last["launches"], last["t"] = read_launches(), time.perf_counter()
    harness.fit(state, data)
    launches = read_launches()
    save_s = time.perf_counter() - last["t"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    if got[1]["disc_loss"] == 0.0 or got[0]["d_weight"] <= 0.0:
        raise AssertionError(f"the discriminator or the adaptive weight was not engaged: {got}")
    log(f"[first stage] the plain attention's steps 1-2: {ref_losses}")
    check_first_stage_gaps(first_stage_gaps(got[:2], grads, ref_losses, ref_grads))
    steady = times[1:]
    log(f"[first stage] {FIRST_STAGE_STEPS} steps: {' '.join(f'{t * 1e3:.1f}' for t in times)} "
        f"ms; median of steps 2-{FIRST_STAGE_STEPS} {1e3 * float(np.median(steady)):.1f} ms per "
        f"step; peak memory allocated {peak:.2f} GiB; save on exit {save_s:.2f} s; launches "
        f"{launches}")
    return launches


def ldm_1p4b_main_path() -> dict:
    """Training of the LAION 1.4B LDM with its BERT through the training
    CLI's --base path; Trainer.fit's save on exit goes to a temporary
    directory, removed whether the phase passes or fails."""
    with tempfile.TemporaryDirectory(prefix="txt2img_1p4b_train_") as logdir:
        return _train_1p4b(logdir)


def _train_1p4b(logdir: str) -> dict:
    from sd_tpu_torch.scripts.train import build_trainer, parse_args
    from sd_tpu_torch.training.trainer import CAL_STREAM

    t0 = time.perf_counter()
    harness, state, data = build_trainer(parse_args(
        ["--base", LDM_1P4B_CONFIG, "-t", "--logdir", logdir, "--seed", "0", "--max_steps",
         str(LDM_1P4B_STEPS), "--log_every", "1", "--no_images", "--ckpt_every", "1000",
         "model.params.learn_logvar=true", "model.params.scale_by_std=true",
         "model.params.scale_factor=1.0"]))
    trainer = harness.trainer_obj
    bert = trainer.ldm.cond_stage_model
    named = state.trainables()
    n_unet = sum(p.numel() for p in state.unet.parameters())
    n_bert = sum(p.numel() for p in bert.parameters())
    log(f"[1.4B] txt2img-1p4B ({LDM_1P4B_CONFIG}; learn_logvar, scale_by_std, scale_factor 1 by "
        f"dotlist): {n_unet / 1e6:.1f}M UNet and {n_bert / 1e6:.1f}M BERTEmbedder parameters "
        f"trained in fp32 (AdamW, bf16 autocast, use_checkpoint "
        f"{state.unet.config.use_checkpoint}), frozen kl-f8 encoder in bf16; batch "
        f"{data.batch_size} of 256² images, 77 token ids; built in "
        f"{time.perf_counter() - t0:.1f} s; {LDM_1P4B_STEPS} steps (no cut)")
    before = {n: p.detach().clone() for n, p in bert.named_parameters()}
    trainer.calibrate_scale_by_std = _Timed(trainer.calibrate_scale_by_std)
    times = []
    last = {"t": time.perf_counter(), "launches": read_launches()}
    train_step = trainer.train_step

    def checked_step(state_, batch_, generator):
        aux = train_step(state_, batch_, generator)
        torch.cuda.synchronize()
        launches = read_launches()
        delta = {k: launches[k] - last["launches"][k] for k in launches}
        if state_.step == 1:  # fit calibrated scale_factor before it
            cal = trainer.calibrate_scale_by_std.calls[0]["launches"]
            delta = {k: v - cal[k] for k, v in delta.items()}
        times.append(time.perf_counter() - last["t"])
        loss = float(aux["loss"])
        bad = [n for n, p in named.items()
               if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.any()]
        log(f"[1.4B] step {state_.step}: loss {loss:.5f}, {times[-1] * 1e3:.1f} ms, launches "
            f"{delta}, trained tensors without a finite non-zero gradient: {len(bad)} of "
            f"{len(named)}")
        if not np.isfinite(loss) or bad:
            raise AssertionError(f"1.4B step {state_.step}: loss {loss}, no gradient on {bad[:8]}")
        if delta != expect(**LDM_1P4B_LAUNCHES):
            raise AssertionError(f"1.4B step {state_.step}: launches {delta} != "
                                 f"{LDM_1P4B_LAUNCHES}")
        last["t"], last["launches"] = time.perf_counter(), launches
        return aux

    trainer.train_step = checked_step
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    last["launches"] = read_launches()
    fit_t0 = last["t"] = time.perf_counter()
    harness.fit(state, data)
    launches = read_launches()
    save_s = time.perf_counter() - last["t"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    (cal,) = trainer.calibrate_scale_by_std.calls
    scale = cal["out"]
    # the calibration again: the first batch's latents from the same draw
    images = torch.from_numpy(data.train_dataloader().batch(0)["image"]).cuda()
    with torch.no_grad(), trainer.autocast():
        posterior = trainer.ldm.encode_first_stage(images.permute(0, 3, 1, 2))
    z = posterior.sample(harness._generator(0, CAL_STREAM)).float()
    want = 1.0 / float(z.flatten().std())
    log(f"[1.4B] scale_by_std: scale_factor {scale!r} in {cal['s']:.2f} s (launches "
        f"{cal['launches']}); recomputed {want!r}; the trainer holds "
        f"{trainer.ldm.scale_factor!r}")
    if not (abs(scale - want) <= 1e-3 * want and trainer.ldm.scale_factor == scale
            and cal["launches"] == expect(flash_attention=1)):
        raise AssertionError(f"scale_by_std: {scale} against {want}")
    moved = {n: (p.detach() - before[n]).abs().max().item() for n, p in bert.named_parameters()}
    still = [n for n, m in moved.items() if not m > 0]
    logvar_moved = int((state.logvar.detach() != 0).sum())
    log(f"[1.4B] BERTEmbedder: {len(moved) - len(still)} of {len(moved)} tensors moved (largest "
        f"move {max(moved.values()):.3e}); logvar moved at {logvar_moved} timesteps")
    if still or logvar_moved == 0:
        raise AssertionError(f"BERT tensors that did not move: {still[:8]}; logvar moved at "
                             f"{logvar_moved}")
    check_metrics_written("1.4B", harness.logdir, LDM_1P4B_STEPS)
    steady = times[1:]
    log(f"[1.4B] {LDM_1P4B_STEPS} steps: {' '.join(f'{t * 1e3:.1f}' for t in times)} ms "
        f"(the first with the calibration); median of steps 2-{LDM_1P4B_STEPS} "
        f"{1e3 * float(np.median(steady)):.1f} ms per step; peak memory allocated {peak:.2f} "
        f"GiB; fit {time.perf_counter() - fit_t0:.1f} s with the save on exit {save_s:.2f} s; "
        f"launches {launches}")
    return launches


def check_metrics_written(label: str, logdir: str, steps: int) -> None:
    """A --base LDM run logging every step wrote one metrics.jsonl row a
    step (a finite loss, a positive rate) and a TensorBoard event file
    under <logdir>/tb."""
    path = os.path.join(logdir, "metrics.jsonl")
    rows = [json.loads(line) for line in open(path)] if os.path.exists(path) else []
    events = [f for f in (os.listdir(os.path.join(logdir, "tb"))
                          if os.path.isdir(os.path.join(logdir, "tb")) else [])
              if f.startswith("events.out.tfevents.")]
    sizes = [os.path.getsize(os.path.join(logdir, "tb", f)) for f in events]
    log(f"[{label}] metrics.jsonl: {len(rows)} rows, steps {[r.get('step') for r in rows]}; "
        f"TensorBoard event files {events} ({sizes} bytes)")
    if ([r.get("step") for r in rows] != list(range(1, steps + 1)) or len(events) != 1
            or not all(np.isfinite(r["train/loss"]) and r["train/it_per_sec"] > 0
                       for r in rows)):
        raise AssertionError(f"[{label}] metrics.jsonl rows {rows} or event files {events}")


def check_latent_gate(label: str, got: torch.Tensor, plain: torch.Tensor,
                      versus: str = "K1's plain version") -> float:
    """The kernels' latents against the plain attention's (or ``versus``),
    relative L2 within AGREEMENT_TOL and not identical."""
    got, plain = got.float().cpu(), plain.float().cpu()
    rel = ((got - plain).norm() / plain.norm()).item()
    log(f"[{label}] latents against {versus}: relative L2 {rel:.4e} (bound "
        f"{AGREEMENT_TOL})")
    if not (np.isfinite(rel) and rel < AGREEMENT_TOL) or torch.equal(got, plain):
        raise AssertionError(f"[{label}] relative L2 {rel} against {versus} "
                             f"(or identical to it)")
    return rel


def inpaint_main_path() -> dict:
    """[inpaint]: inpainting_big at full width, bf16, built as the inpaint
    CLI builds it; one 512² request, DDIM 50, with the kernels and again
    with the plain attention."""
    from sd_tpu_torch.scripts import inpaint as cli

    t_phase = time.perf_counter()
    opt = cli.parse_args(["--indir", ".", "--outdir", ".", "--config", INPAINT_CONFIG])
    pipe = cli.build_pipeline(opt)
    torch.cuda.synchronize()
    n_unet = sum(p.numel() for p in pipe.ldm.model.diffusion_model.parameters())
    n_vq = sum(p.numel() for p in pipe.ldm.first_stage_model.parameters())
    log(f"[inpaint] inpainting_big, {n_unet / 1e6:.1f}M UNet and {n_vq / 1e6:.1f}M VQ-f4 "
        f"parameters in bf16, built in {time.perf_counter() - t_phase:.1f} s")
    image = synthetic_image(512, seed=2)
    mask = np.zeros((512, 512), np.float32)
    mask[128:352, 160:416] = 1.0
    latents = []
    for plain in (False, True):
        reset_launches()
        with plain_attention(plain):
            out = pipe(image, mask, torch.Generator(device="cuda").manual_seed(opt.seed),
                       steps=STEPS)
        counts = read_launches()
        t = pipe.last_timings
        label = "plain attention" if plain else "K1"
        log(f"[inpaint] 512², DDIM {STEPS}, batch 1, {label}: {t['total_s']:.3f} s (encode "
            f"{t['encode_s']:.3f}, sample {t['sample_s']:.3f}, decode {t['decode_s']:.3f}); "
            f"{t['sample_s'] * 1e3 / STEPS:.2f} ms per UNet evaluation; launches {counts}")
        want = expect(flash_attention=0 if plain else SITES_PER_UNET * STEPS)
        if counts != want:
            raise AssertionError(f"[inpaint] {label}: launch counts {counts} != {want}")
        keep = mask == 0
        if out.shape != (1, 512, 512, 3) or not np.array_equal(out[0][keep], image[keep]):
            raise AssertionError(f"[inpaint] {label}: {out.shape}, or the pixels outside the "
                                 f"mask changed")
        if out[0][~keep].std() == 0 or not torch.isfinite(pipe.last_latents).all():
            raise AssertionError(f"[inpaint] {label}: a constant fill or latents not finite")
        latents.append(pipe.last_latents)
        if not plain:
            kernel_counts = counts
    log("[inpaint] the pixels outside the mask equal the input's in both runs")
    check_latent_gate("inpaint", *latents)
    del pipe
    free_memory()
    log(f"[inpaint] phase {time.perf_counter() - t_phase:.1f} s")
    return kernel_counts


def check_code_agreement(quantize, latents: torch.Tensor, label: str = "sample_diffusion"
                         ) -> float:
    """The share of the card's code indices (bf16 latents, fp32 distances)
    that the same quantizer in fp32 on the CPU gives on the same latents."""
    z = latents.to(quantize.embedding.weight.dtype)
    got = quantize.indices(z).cpu()
    cpu = copy.deepcopy(quantize).float().cpu()
    want = cpu.indices(z.float().cpu())
    same = int((got == want).sum())
    share = same / want.numel()
    log(f"[{label}] code indices: the card's equal the CPU fp32 quantizer's at "
        f"{same} of {want.numel()} latents ({share:.6f}; bound {CODE_AGREEMENT_MIN}), "
        f"{len(torch.unique(want))} distinct codes")
    if share < CODE_AGREEMENT_MIN:
        raise AssertionError(f"[{label}] code agreement {share}")
    return share


def sample_diffusion_main_path() -> dict:
    """[sample_diffusion]: the CLI's main() on CelebA-HQ's config at batch
    4, 256², DDIM 50 at eta 1, then a second build sampling with the plain
    attention; the code indices of the latents on the card and the CPU."""
    from sd_tpu_torch.scripts import sample_diffusion as cli

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sample_diffusion_") as d:
        argv = ["-c", CELEBAHQ_CONFIG, "-n", str(CELEBAHQ_BATCH), "--batch_size",
                str(CELEBAHQ_BATCH), "-l", d]
        reset_launches()
        out = cli.main(argv)
        counts = read_launches()
        wall = time.perf_counter() - t_phase
        arr = np.load(out["npz"])["arr_0"]
        log(f"[sample_diffusion] CelebA-HQ LDM-VQ-4, batch {CELEBAHQ_BATCH}, 256², DDIM "
            f"{STEPS} at eta 1: {out['samples_per_s'][0]:.4f} samples/s (main() with its build "
            f"{wall:.1f} s); wrote {os.path.basename(out['npz'])} {arr.shape}; launches {counts}")
        want = expect(flash_attention=SITES_PER_UNET * STEPS + 1)
        if counts != want:
            raise AssertionError(f"[sample_diffusion] launch counts {counts} != {want}")
        if arr.shape != (CELEBAHQ_BATCH, 256, 256, 3) or any(a.min() == a.max() for a in arr):
            raise AssertionError(f"[sample_diffusion] .npz {arr.shape} or a constant image")
        if not torch.isfinite(out["latents"]).all():
            raise AssertionError("[sample_diffusion] latents not finite")
        opt = cli.parse_args(argv[:-1] + [os.path.join(d, "plain")])
        ldm, hw, channels = cli.build_model(opt)
        with plain_attention():
            plain = cli.sample(ldm, hw, channels, opt)
    check_latent_gate("sample_diffusion", out["latents"], plain["latents"])
    check_code_agreement(ldm.first_stage_model.quantize, out["latents"] / ldm.scale_factor)
    del ldm
    free_memory()
    log(f"[sample_diffusion] phase {time.perf_counter() - t_phase:.1f} s")
    return counts


def cin256_main_path() -> dict:
    """[cin256]: sample_diffusion's main() on cin256-v2 at the notebook's
    settings, batch 4, 256², then a second build sampling with the plain
    attention; the code indices on the card and the CPU."""
    from sd_tpu_torch.scripts import sample_diffusion as cli

    from sd_tpu_torch.ops.attention import attention_route

    t_phase = time.perf_counter()
    # the route of each kind of self-attention site at B=8: d = 960 at N = 64,
    # which sd_tpu leaves to XLA, takes K1's split plan
    routes = {(n, d): attention_route("cuda", torch.bfloat16, 8, n, n, 1, d)
              for n, d in ((1024, 384), (256, 576), (64, 960))}
    log(f"[cin256] routes (N, d): {routes}")
    if routes != {(1024, 384): "K1", (256, 576): "K1", (64, 960): "K1"}:
        raise AssertionError(f"[cin256] attention routes {routes}")
    with tempfile.TemporaryDirectory(prefix="cin256_") as d:
        argv = ["-c", CIN256_CONFIG] + CIN256_ARGS + ["-l", d]
        reset_launches()
        out = cli.main(argv)
        counts = read_launches()
        wall = time.perf_counter() - t_phase
        arr = np.load(out["npz"])["arr_0"]
        log(f"[cin256] cin256-v2, classes 25,187,448,992, guidance 3.0, batch 4, 256², DDIM "
            f"{CIN256_STEPS} at eta 0: {out['samples_per_s'][0]:.4f} samples/s (main() with "
            f"its build {wall:.1f} s); wrote {os.path.basename(out['npz'])} {arr.shape}; "
            f"launches {counts}")
        want = expect(flash_attention=CIN256_K1_SITES * CIN256_STEPS + 1,
                      geglu_ff=CIN256_K2_SITES * CIN256_STEPS)
        if counts != want:
            raise AssertionError(f"[cin256] launch counts {counts} != {want}")
        if arr.shape != (4, 256, 256, 3) or any(a.min() == a.max() for a in arr):
            raise AssertionError(f"[cin256] .npz {arr.shape} or a constant image")
        if not torch.isfinite(out["latents"]).all():
            raise AssertionError("[cin256] latents not finite")
        opt = cli.parse_args(argv[:-1] + [os.path.join(d, "plain")])
        ldm, hw, channels = cli.build_model(opt)
        n_unet = sum(p.numel() for p in ldm.model.diffusion_model.parameters())
        log(f"[cin256] {n_unet / 1e6:.1f}M UNet parameters in bf16")
        with plain_attention():
            plain = cli.sample(ldm, hw, channels, opt)
    check_latent_gate("cin256", out["latents"], plain["latents"])
    check_code_agreement(ldm.first_stage_model.quantize, out["latents"] / ldm.scale_factor,
                         "cin256")
    del ldm
    free_memory()
    log(f"[cin256] phase {time.perf_counter() - t_phase:.1f} s")
    return counts


def _sr_split_run(ldm, lr: torch.Tensor, seed: int) -> tuple:
    """The tiled LDM's run: DDIM from the generator's x_T with the LR image
    as the concat condition, then the patch-distributed decode."""
    from sd_tpu_torch.samplers.ddim import ddim_sample

    generator = torch.Generator(device="cuda").manual_seed(seed)
    x_T = torch.randn((1, 3) + tuple(lr.shape[2:]), generator=generator, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        z = ddim_sample(ldm.apply_model, ldm.schedule, x_T, {"c_concat": lr},
                        num_steps=SR_SPLIT_STEPS, eta=1.0, generator=generator)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        image = ldm.decode_first_stage(z)
        torch.cuda.synchronize()
    return z, image, t1 - t0, time.perf_counter() - t1


def superres_main_path() -> dict:
    """[superres]: bsr_sr at full width through SuperResPipeline (64² to
    256², 9 tiles, DDIM 100 at eta 1), then through the LDM's
    split_input_params (a 256² LR image, DDIM 20 at eta 1), each again with
    the plain attention."""
    from sd_tpu_torch.pipelines.build import inference_dtype
    from sd_tpu_torch.pipelines.superres import SuperResPipeline, prepare_sr_cond
    from sd_tpu_torch.utils import config as C

    t_phase = time.perf_counter()
    cfg = C.load_yaml(SR_CONFIG)["model"]
    device = torch.device("cuda")
    ldm = C.build_latent_diffusion(cfg, device=device, dtype=inference_dtype(device), seed=0)
    torch.cuda.synchronize()
    n_unet = sum(p.numel() for p in ldm.model.diffusion_model.parameters())
    log(f"[superres] bsr_sr, {n_unet / 1e6:.1f}M UNet parameters in bf16, built in "
        f"{time.perf_counter() - t_phase:.1f} s")
    pipe = SuperResPipeline(ldm=ldm)
    lr_image = synthetic_image(64, seed=3)
    total = {}
    latents = []
    for plain in (False, True):
        reset_launches()
        with plain_attention(plain):
            out = pipe(lr_image, torch.Generator(device="cuda").manual_seed(1), steps=SR_STEPS,
                       eta=1.0)
        counts = read_launches()
        t = pipe.last_timings
        label = "plain attention" if plain else "K1"
        log(f"[superres] SuperResPipeline 64² -> 256², {pipe.last_latents.shape[0]} tiles, DDIM "
            f"{SR_STEPS} at eta 1, {label}: {t['total_s']:.3f} s (sample {t['sample_s']:.3f}, "
            f"decode {t['decode_s']:.3f}); launches {counts}")
        want = expect(flash_attention=0 if plain else SR_K1_SITES * SR_STEPS + 1)
        if counts != want or pipe.last_latents.shape[0] != 9:
            raise AssertionError(f"[superres] {label}: launch counts {counts} != {want}, or "
                                 f"{pipe.last_latents.shape[0]} tiles")
        if out.shape != (1, 256, 256, 3) or out.min() == out.max():
            raise AssertionError(f"[superres] {label}: {out.shape} or a constant image")
        if not torch.isfinite(pipe.last_latents).all():
            raise AssertionError(f"[superres] {label}: latents not finite")
        latents.append(pipe.last_latents)
        if not plain:
            total = add_counts(total, counts)
    check_latent_gate("superres", *latents)

    ldm.split_input_params = SR_SPLIT_PARAMS
    lr = torch.from_numpy(prepare_sr_cond(synthetic_image(256, seed=4))[0]).cuda()
    lr = lr.permute(0, 3, 1, 2)
    latents = []
    for plain in (False, True):
        reset_launches()
        with plain_attention(plain):
            z, image, sample_s, decode_s = _sr_split_run(ldm, lr, seed=2)
        counts = read_launches()
        label = "plain attention" if plain else "K1"
        log(f"[superres] split_input_params 256² LR -> {tuple(image.shape[2:])}, 9 UNet patches "
            f"of 128², 225 decode patches, DDIM {SR_SPLIT_STEPS} at eta 1, {label}: sample "
            f"{sample_s:.3f} s, decode {decode_s:.3f} s; launches {counts}")
        want = expect(flash_attention=0 if plain else SR_K1_SITES * SR_SPLIT_STEPS + 1)
        if counts != want:
            raise AssertionError(f"[superres] split {label}: launch counts {counts} != {want}")
        if image.shape != (1, 3, 1024, 1024) or not torch.isfinite(image).all():
            raise AssertionError(f"[superres] split {label}: {tuple(image.shape)} or not finite")
        latents.append(z)
        if not plain:
            total = add_counts(total, counts)
    check_latent_gate("superres split", *latents)
    del ldm, pipe
    free_memory()
    log(f"[superres] phase {time.perf_counter() - t_phase:.1f} s")
    return total


def check_searcher() -> float:
    """A Searcher on the card over a seeded SEARCH_ROWS x 768 fp32 database:
    the top SEARCH_K of SEARCH_QUERIES queries against a float64 top-k of
    the same rows on the host (near-ties within SEARCH_TIE may trade
    places), the scores within SEARCH_SCORE_TOL; returns the search's ms."""
    from sd_tpu_torch.pipelines.retrieval import Searcher

    g = torch.Generator(device="cuda").manual_seed(7)
    db = torch.randn((SEARCH_ROWS, 768), generator=g, device="cuda")
    queries = torch.randn((SEARCH_QUERIES, 768), generator=g, device="cuda").cpu().numpy()
    t0 = time.perf_counter()
    searcher = Searcher(db, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    host = db.cpu().numpy().astype(np.float64)
    del db
    out = searcher(queries, k=SEARCH_K)
    ms = time_ms(lambda: searcher(queries, k=SEARCH_K), iters=10, warmup=2)
    host /= np.linalg.norm(host, axis=-1, keepdims=True) + 1e-8
    q = queries.astype(np.float64)
    q /= np.linalg.norm(q, axis=-1, keepdims=True) + 1e-8
    scores = q @ host.T
    del host
    ref = np.argsort(-scores, axis=1)[:, :SEARCH_K]
    swapped, score_err = 0, 0.0
    for i in range(SEARCH_QUERIES):
        kth = scores[i, ref[i, -1]]
        for j in set(out["nn_indices"][i]) ^ set(ref[i]):
            swapped += 1
            if abs(scores[i, j] - kth) > SEARCH_TIE:
                raise AssertionError(f"[knn2img] Searcher: query {i} neighbours "
                                     f"{out['nn_indices'][i]} against {ref[i]} (float64)")
        score_err = max(score_err, float(np.abs(out["scores"][i]
                                                - scores[i, out["nn_indices"][i]]).max()))
    nbytes = SEARCH_ROWS * 768 * 4
    log(f"[knn2img] Searcher over {SEARCH_ROWS} x 768 fp32 ({nbytes / 1e9:.2f} GB; normalized "
        f"on the card in {load_s:.2f} s): top-{SEARCH_K} of {SEARCH_QUERIES} queries equal to "
        f"the float64 top-k on the host ({swapped} near-tie swaps), scores max abs err "
        f"{score_err:.3e} (bound {SEARCH_SCORE_TOL}); {ms:.4f} ms a search, bound "
        f"{nbytes / PEAK_BYTES * 1e3:.4f} ms (the database's bytes)")
    if not score_err <= SEARCH_SCORE_TOL:
        raise AssertionError(f"[knn2img] Searcher scores off by {score_err}")
    del searcher
    free_memory()
    return ms


def knn2img_main_path() -> dict:
    """[knn2img]: train_searcher's main() over seeded npz parts, the
    Searcher at scale, then knn2img's main() with the 768² RDM, its
    launches exact, its latents against a second build sampling with the
    plain K1 and K2."""
    from PIL import Image

    from sd_tpu_torch.scripts import knn2img, train_searcher

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="knn2img_") as d:
        parts = os.path.join(d, "parts")
        os.makedirs(parts)
        rng = np.random.default_rng(0)
        for i in range(INDEX_PARTS):
            np.savez(os.path.join(parts, f"part{i:02}.npz"),
                     embedding=rng.standard_normal((INDEX_ROWS, 768), dtype=np.float32))
        t0 = time.perf_counter()
        index = train_searcher.main(["-d", parts, "-t", os.path.join(d, "index.npz")])
        emb = np.load(index)["embedding"]
        norms = np.linalg.norm(emb, axis=-1)
        log(f"[knn2img] train_searcher: {INDEX_PARTS} parts into {emb.shape} in "
            f"{time.perf_counter() - t0:.2f} s, row norms {norms.min():.6f} to {norms.max():.6f}")
        if emb.shape != (INDEX_PARTS * INDEX_ROWS, 768) or np.abs(norms - 1).max() > 1e-5:
            raise AssertionError(f"[knn2img] index {emb.shape}, norms {norms.min()} {norms.max()}")
        search_ms = check_searcher()
        argv = ["--config", RDM_CONFIG, "--n_samples", str(RDM_SAMPLES), "--ddim_steps",
                str(RDM_STEPS), "--scale", str(RDM_SCALE), "--knn", str(RDM_KNN),
                "--use_neighbors", "--database", index, "--seed", "0", "--outdir",
                os.path.join(d, "out")]
        reset_launches()
        t0 = time.perf_counter()
        out = knn2img.main(argv)
        counts = read_launches()
        wall = time.perf_counter() - t0
        sizes = [Image.open(p).size for p in out["paths"]]
        log(f"[knn2img] RDM 768², {RDM_SAMPLES} samples, DDIM {RDM_STEPS} at eta 0, guidance "
            f"{RDM_SCALE}, {RDM_KNN} neighbours (context {tuple(out['cond'].shape)}): "
            f"{out['samples_per_s']:.4f} samples/s (main() with its build and the search "
            f"{wall:.1f} s); wrote {len(out['paths'])} PNGs {sizes}; launches {counts}")
        want = expect(flash_attention=RDM_K1_SITES * RDM_STEPS + RDM_DECODER_SITES,
                      geglu_ff=RDM_K2_SITES * RDM_STEPS)
        if counts != want:
            raise AssertionError(f"[knn2img] launch counts {counts} != {want}")
        if sizes != [(768, 768)] * RDM_SAMPLES or not torch.isfinite(out["latents"]).all():
            raise AssertionError(f"[knn2img] PNGs {sizes} or latents not finite")
        opt = knn2img.parse_args(argv)
        ldm, _, downsample, channels = knn2img.build_model(opt)
        n_unet = sum(p.numel() for p in ldm.model.diffusion_model.parameters())
        log(f"[knn2img] {n_unet / 1e6:.1f}M UNet parameters in bf16")
        with plain_kernels():
            plain = knn2img.sample(ldm, out["cond"], torch.zeros_like(out["cond"]), downsample,
                                   channels, opt)
    check_latent_gate("knn2img", out["latents"], plain, "K1's and K2's plain versions")
    del ldm
    free_memory()
    log(f"[knn2img] phase {time.perf_counter() - t_phase:.1f} s (search {search_ms:.4f} ms)")
    return counts


def _extras_models():
    """(name, module, inputs) of the [vae extras] phase at full width, each
    built on the card with seeded random weights in bf16."""
    from sd_tpu_torch.models.vae_extras import (MergedRescaleDecoder, MergedRescaleEncoder,
                                                TimestepVAEModel)
    from sd_tpu_torch.utils.config import init_random_

    g = torch.Generator(device="cuda").manual_seed(3)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
    b = EXTRAS_BATCH
    t = torch.tensor([10, 250, 500, 990], device="cuda")
    specs = [
        ("MergedRescaleEncoder", lambda: MergedRescaleEncoder(
            in_channels=3, ch=128, resolution=256, out_ch=16, num_res_blocks=2,
            ch_mult=(1, 2, 4, 8)), (randn(b, 3, 256, 256),)),
        ("MergedRescaleDecoder", lambda: MergedRescaleDecoder(
            z_channels=128, out_ch=3, resolution=256, num_res_blocks=2, ch=128,
            ch_mult=(1, 2, 4, 8)), (randn(b, 128, 32, 32),)),
        ("TimestepVAEModel", lambda: TimestepVAEModel(
            ch=128, ch_mult=(1, 2, 4, 8), num_res_blocks=2, in_channels=6, resolution=256),
         (randn(b, 3, 256, 256), t, randn(b, 3, 256, 256)))]
    for name, make, inputs in specs:
        with torch.device("meta"):
            module = make()
        module.to_empty(device="cuda")
        init_random_(module, torch.Generator(device="cuda").manual_seed(0))
        yield name, module.to(torch.bfloat16).eval(), inputs


def vae_extras_main_path() -> dict:
    """[vae extras]: MergedRescaleEncoder, MergedRescaleDecoder and
    TimestepVAEModel at full width in bf16, K1 at d = 1024, each against
    itself with the plain attention; TimestepVAEModel again in the
    fused-conv mode (K7 with its timestep offset) against its unfused run."""
    from sd_tpu_torch.ops.resblock import set_conv_modes

    t_phase = time.perf_counter()
    total = expect()
    for name, module, inputs in _extras_models():
        n = sum(p.numel() for p in module.parameters())
        with torch.no_grad():
            reset_launches()
            t0 = time.perf_counter()
            out = module(*inputs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = read_launches()
            log(f"[vae extras] {name}: {n / 1e6:.1f}M parameters, {tuple(inputs[0].shape)} -> "
                f"{tuple(out.shape)} in {seconds * 1e3:.1f} ms (first call); launches {counts}")
            if counts != expect(flash_attention=EXTRAS_K1[name]):
                raise AssertionError(f"[vae extras] {name}: launches {counts}")
            total = add_counts(total, counts)
            with plain_attention():
                plain = module(*inputs)
            check_latent_gate(f"vae extras {name}", out, plain)
            if name == "TimestepVAEModel":
                set_conv_modes(module, fused_conv="1")
                reset_launches()
                fused = module(*inputs)
                torch.cuda.synchronize()
                counts = read_launches()
                set_conv_modes(module, fused_conv="0")
                log(f"[vae extras] {name} under SD_TPU_FUSED_CONV=1: launches {counts}")
                want = expect(flash_attention=EXTRAS_K1[name],
                              fused_conv3x3=2 * TIMESTEP_FUSED_BLOCKS)
                if counts != want:
                    raise AssertionError(f"[vae extras] fused {name}: launches {counts} != {want}")
                total = add_counts(total, counts)
                check_latent_gate(f"vae extras fused {name}", fused, out, "its unfused output")
        del module, out, plain
        free_memory()
    log(f"[vae extras] phase {time.perf_counter() - t_phase:.1f} s; launches {total}")
    return total


def write_data_tree(root: str) -> dict:
    """Seeded JPEGs in the datasets' layouts under ``root``: an LSUN
    ``txt_file`` over LSUN_IMAGES 256² images under a ``data_root``, and an
    ImageNet flat root of IMAGENET_IMAGES images of 320x288 and 288x320 in
    four synset folders with ``filelist.txt``, and an HR-index pickle over
    all of them in a seeded order."""
    import pickle

    from PIL import Image

    t0 = time.perf_counter()
    lsun, imagenet = os.path.join(root, "lsun"), os.path.join(root, "imagenet")
    rels = []
    for i in range(LSUN_IMAGES):
        rels.append(f"bedroom/{i:04d}.jpg")
        os.makedirs(os.path.join(lsun, "bedroom"), exist_ok=True)
        Image.fromarray(synthetic_image(256, seed=100 + i)).save(
            os.path.join(lsun, rels[-1]), quality=90)
    txt = os.path.join(root, "lsun_bedrooms_train.txt")
    with open(txt, "w") as f:
        f.write("\n".join(rels) + "\n")
    rels = []
    for i in range(IMAGENET_IMAGES):
        syn = f"n0{i % 4}000000"
        rels.append(f"{syn}/{syn}_{i}.JPEG")
        os.makedirs(os.path.join(imagenet, syn), exist_ok=True)
        img = synthetic_image(320, seed=200 + i)
        img = img[:288] if i % 2 else img[:, :288]
        Image.fromarray(img).save(os.path.join(imagenet, rels[-1]), quality=90)
    with open(os.path.join(imagenet, "filelist.txt"), "w") as f:
        f.write("\n".join(sorted(rels)) + "\n")
    hr = os.path.join(root, "imagenet_train_hr_indices.p")
    with open(hr, "wb") as f:
        pickle.dump(np.random.default_rng(0).permutation(IMAGENET_IMAGES).tolist(), f)
    log(f"[data] wrote {LSUN_IMAGES} LSUN-style and {IMAGENET_IMAGES} ImageNet-style JPEGs and "
        f"an HR-index pickle in {time.perf_counter() - t0:.2f} s")
    return {"lsun": lsun, "lsun_txt": txt, "imagenet": imagenet, "hr": hr}


def data_main_paths() -> list:
    """The VQ-f4 models' training paths over one synthetic data tree in a
    temporary directory, removed whether the phases pass or fail; returns
    each phase's launch counts."""
    with tempfile.TemporaryDirectory(prefix="vq_f4_data_") as root:
        tree = write_data_tree(root)
        check_native_loader(tree)
        runs = [vq_first_stage_main_path(tree, root)]
        free_memory()
        runs.append(ldm_uncond_main_path(tree, root))
        free_memory()
        runs.append(ldm_concat_main_path(tree, root))
        free_memory()
        runs.append(classifier_main_path(tree))
        free_memory()
    return runs


def native_toolchain_missing() -> Optional[str]:
    """None where g++ compiles and links against libjpeg's and libpng's
    headers and libraries, else the compiler's first complaint."""
    import shutil

    cxx = shutil.which("g++")
    if cxx is None:
        return "no g++ on PATH"
    proc = subprocess.run([cxx, "-x", "c++", "-", "-o", os.devnull, "-ljpeg", "-lpng"],
                          input="#include <cstdio>\n#include <jpeglib.h>\n#include <png.h>\n"
                                "int main() { return 0; }\n",
                          capture_output=True, text=True, timeout=120)
    return None if proc.returncode == 0 else (proc.stderr.strip().splitlines() or ["?"])[0]


def check_native_loader(tree: dict) -> None:
    """[native loader]: NativeImageLoader.load_batch over the LSUN tree at
    256² (the images' size: decode and crop only) against LSUNBedroomsTrain's
    own decode of the same files without flips. Where the machine lacks
    libjpeg's or libpng's headers or libraries, says so and runs nothing:
    the loader is host code, held against sd_tpu's by the CPU tests."""
    missing = native_toolchain_missing()
    if missing is not None:
        log(f"[native loader] not run on this machine: g++ cannot build against libjpeg and "
            f"libpng here ({missing}); the loader stays off the card")
        return
    from sd_tpu_torch.data.lsun import LSUNBedroomsTrain
    from sd_tpu_torch.data.native_loader import NativeImageLoader

    ds = LSUNBedroomsTrain(txt_file=tree["lsun_txt"], data_root=tree["lsun"], size=256,
                           flip_p=0.0)
    paths = [os.path.join(tree["lsun"], rel) for rel in ds.image_paths]
    loader = NativeImageLoader(num_threads=8)
    t0 = time.perf_counter()
    got, ok = loader.load_batch(paths, 256)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = np.stack([ds[i]["image"] for i in range(len(ds))])
    python_ms = (time.perf_counter() - t0) * 1e3
    loader.close()
    err = float(np.abs(got - want).max())
    log(f"[native loader] {len(paths)} LSUN JPEGs at 256²: {native_ms:.1f} ms (8 threads) "
        f"against the dataset's {python_ms:.1f} ms; max abs difference {err:.3e} (bound 1e-6)")
    if not ok.all() or not err <= 1e-6:
        raise AssertionError(f"[native loader] ok {ok.tolist()}, max abs difference {err}")


def checked_fit(label: str, harness, state, data, want: dict, describe) -> list:
    """``harness.fit`` with each step checked: exact launch counts ``want``
    (the counters reset just before fit), finite logs, and ``describe(aux)``
    logged; returns each step's logs (floats) and time, and fit's launches."""
    trainer = harness.trainer_obj
    train_step = trainer.train_step
    steps = []
    last = {}

    def checked_step(state_, batch_, generator):
        aux = train_step(state_, batch_, generator)
        torch.cuda.synchronize()
        launches = read_launches()
        delta = {k: launches[k] - last["launches"][k] for k in launches}
        logs = {k: float(v) for k, v in aux.items()}
        steps.append({"logs": logs, "s": time.perf_counter() - last["t"]})
        log(f"[{label}] step {state_.step}: {describe(logs)}, {steps[-1]['s'] * 1e3:.1f} ms, "
            f"launches {delta}")
        if not all(np.isfinite(v) for v in logs.values()):
            raise AssertionError(f"[{label}] step {state_.step}: {logs}")
        if delta != expect(**want):
            raise AssertionError(f"[{label}] step {state_.step}: launches {delta} != {want}")
        last["t"], last["launches"] = time.perf_counter(), launches
        return aux

    trainer.train_step = checked_step
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    last["launches"], last["t"] = read_launches(), time.perf_counter()
    harness.fit(state, data)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    times = [st["s"] for st in steps]
    log(f"[{label}] {len(steps)} steps: {' '.join(f'{t * 1e3:.1f}' for t in times)} ms; median "
        f"of steps 2-{len(steps)} {1e3 * float(np.median(times[1:])):.1f} ms per step; peak "
        f"memory allocated {peak:.2f} GiB; the save on exit {time.perf_counter() - last['t']:.2f} "
        f"s; launches {launches}")
    if len(steps) != DATA_STEPS:
        raise AssertionError(f"[{label}] {len(steps)} steps, not {DATA_STEPS}")
    return steps, launches


def check_relative(label: str, got: dict, want: dict, bounds: dict) -> None:
    """Each key of ``bounds`` of ``got`` against ``want``, relative, within
    its bound."""
    gaps = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in bounds}
    log(f"[{label}] step 1 against the plain attention (relative gap, bound): " + ", ".join(
        f"{k} {g:.3e} ({bounds[k]})" for k, g in gaps.items()))
    bad = {k: g for k, g in gaps.items() if not g <= bounds[k]}
    if bad:
        raise AssertionError(f"[{label}] against the plain attention: {bad}")


def vq_first_stage_main_path(tree: dict, root: str) -> dict:
    """[vq first stage]: `python -m sd_tpu_torch.scripts.train --base
    vq-f4.yaml -t` over the ImageNet tree at the file's batch of 8, 256²:
    the first step again with the plain attention from a build of the same
    seed; then the code indices of a batch's latents on the card and the CPU."""
    from sd_tpu_torch.scripts.train import build_trainer, parse_args

    t_phase = time.perf_counter()
    argv = ["--base", VQ_CONFIG, "-t", "--logdir", os.path.join(root, "vq_logs"), "--seed", "0",
            "--max_steps", str(DATA_STEPS), "--log_every", "1", "--no_images",
            f"data.params.train.params.data_root={tree['imagenet']}",
            f"data.params.validation.params.data_root={tree['imagenet']}"]
    (plain,), _ = first_stage_steps(argv, 1, plain=True)
    harness, state, data = build_trainer(parse_args(argv))
    trainer = harness.trainer_obj
    n_params = sum(p.numel() for p in state.ae.parameters())
    log(f"[vq first stage] VQ-f4 VQ-GAN ({VQ_CONFIG}: VQLPIPSWithDiscriminator, disc_start 0, "
        f"disc_weight 0.75), {n_params / 1e6:.1f}M autoencoder parameters in fp32 (Adam, bf16 "
        f"autocast), batch {data.batch_size} of 256² ImageNet crops; {DATA_STEPS} steps")
    shown = ("total_loss", "rec_loss", "quant_loss", "g_loss", "d_weight", "disc_loss",
             "perplexity", "cluster_usage")
    steps, launches = checked_fit("vq first stage", harness, state, data, VQ_GAN_LAUNCHES,
                                  lambda g: ", ".join(f"{k} {g[k]:.5g}" for k in shown))
    first = _vae_gan_losses(steps[0]["logs"])
    if not first["disc_loss"] > 0 or not first["d_weight"] > 0 or not trainer.is_vq:
        raise AssertionError(f"[vq first stage] the discriminator or the adaptive weight was "
                             f"not engaged: {first}")
    log(f"[vq first stage] the plain attention's step 1: {plain}")
    check_relative("vq first stage", first, plain, VQ_GAN_COMPARED)
    batch = data.train_dataloader().batch(0)
    images = torch.from_numpy(batch["image"]).cuda().permute(0, 3, 1, 2)
    with torch.no_grad(), trainer.autocast():
        z = state.ae.encode_pre_quant(images)
    check_code_agreement(state.ae.quantize, z, "vq first stage")
    del harness, state, data, trainer
    log(f"[vq first stage] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def _host_ms_per_batch(data, batches: int = 2) -> float:
    """The data module's host time per train batch (the dataset's decode,
    crops, resizes and degradation, and collation), after the run."""
    loader = data.train_dataloader()
    t0 = time.perf_counter()
    for b in range(batches):
        loader.batch(b % len(loader))
    return (time.perf_counter() - t0) * 1e3 / batches


def ldm_uncond_main_path(tree: dict, root: str) -> dict:
    """[ldm train uncond]: `--base lsun_bedrooms-ldm-vq-4.yaml -t` over the
    LSUN tree at the file's batch of 48; the first step's loss against a
    second build of the same seed with the plain attention."""
    from sd_tpu_torch.scripts.train import build_trainer, parse_args
    from sd_tpu_torch.training.trainer import step_seed

    t_phase = time.perf_counter()
    data_args = [f"data.params.{split}.params.{k}={v}" for split in ("train", "validation")
                 for k, v in (("txt_file", tree["lsun_txt"]), ("data_root", tree["lsun"]))]
    argv = lambda d: ["--base", LSUN_CONFIG, "-t", "--logdir", os.path.join(root, d), "--seed",
                      "0", "--max_steps", str(DATA_STEPS), "--log_every", "1", "--no_images",
                      *data_args]
    opt = parse_args(argv("lsun_plain"))
    harness, _, data = build_trainer(opt)
    generator = torch.Generator("cuda").manual_seed(step_seed(opt.seed, 0))
    with plain_attention(), torch.no_grad():
        plain = float(harness.trainer_obj.loss_fn(data.train_dataloader().batch(0),
                                                  generator)[0])
    del harness, data
    free_memory()
    harness, state, data = build_trainer(parse_args(argv("lsun_logs")))
    ldm = harness.trainer_obj.ldm
    n_unet = sum(p.numel() for p in state.unet.parameters())
    log(f"[ldm train uncond] LSUN-bedrooms LDM-VQ-4 ({LSUN_CONFIG}: conditioning_key "
        f"{ldm.conditioning_key}), {n_unet / 1e6:.1f}M UNet parameters in fp32 (AdamW, bf16 "
        f"autocast), frozen VQ-f4 encoder in bf16; batch {data.batch_size} of 256² LSUN "
        f"images; {DATA_STEPS} steps")
    if ldm.conditioning_key is not None or data.batch_size != LSUN_IMAGES:
        raise AssertionError(f"[ldm train uncond] key {ldm.conditioning_key}, batch "
                             f"{data.batch_size}")
    steps, launches = checked_fit("ldm train uncond", harness, state, data, LSUN_LAUNCHES,
                                  lambda g: f"loss {g['loss']:.6f}")
    check_relative("ldm train uncond", {"loss": steps[0]["logs"]["loss"]}, {"loss": plain},
                   {"loss": FIRST_STAGE_LOSS_TOL})
    log(f"[ldm train uncond] LSUNBedroomsTrain host {_host_ms_per_batch(data):.1f} ms per batch "
        f"of {data.batch_size}")
    del harness, state, data, ldm
    log(f"[ldm train uncond] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def ldm_concat_main_path(tree: dict, root: str) -> dict:
    """[ldm train concat]: `--base bsr_sr.yaml -t` over ImageNet-SR pairs of
    the ImageNet tree (bsrgan_light, 256² to 64², the HR-index pickle) at
    the file's batch of 64; the dataset's host ms per batch beside the
    step's."""
    from sd_tpu_torch.scripts.train import build_trainer, parse_args

    t_phase = time.perf_counter()
    data_args = [f"data.params.{split}.params.{k}={v}" for split in ("train", "validation")
                 for k, v in (("data_root", tree["imagenet"]), ("hr_indices", tree["hr"]))]
    harness, state, data = build_trainer(parse_args(
        ["--base", SR_CONFIG, "-t", "--logdir", os.path.join(root, "sr_logs"), "--seed", "0",
         "--max_steps", str(DATA_STEPS), "--log_every", "1", "--no_images", *data_args]))
    ldm = harness.trainer_obj.ldm
    n_unet = sum(p.numel() for p in state.unet.parameters())
    log(f"[ldm train concat] bsr_sr ({SR_CONFIG}: conditioning_key {ldm.conditioning_key}, "
        f"cond_stage_key {ldm.cond_stage_key}), {n_unet / 1e6:.1f}M UNet parameters in fp32 "
        f"(AdamW, bf16 autocast), frozen VQ-f4 encoder in bf16; batch {data.batch_size} of "
        f"ImageNetSRTrain pairs; {DATA_STEPS} steps")
    if ldm.conditioning_key != "concat":
        raise AssertionError(f"[ldm train concat] conditioning_key {ldm.conditioning_key}")
    steps, launches = checked_fit("ldm train concat", harness, state, data,
                                  SR_TRAIN_LAUNCHES, lambda g: f"loss {g['loss']:.6f}")
    batch = data.train_dataloader().batch(0)
    shapes = {k: np.shape(batch[k]) for k in ("image", "LR_image")}
    if shapes != {"image": (64, 256, 256, 3), "LR_image": (64, 64, 64, 3)}:
        raise AssertionError(f"[ldm train concat] batch shapes {shapes}")
    host, step_ms = _host_ms_per_batch(data), 1e3 * float(np.median([st["s"] for st in steps[1:]]))
    log(f"[ldm train concat] ImageNetSRTrain (bsrgan_light) host {host:.1f} ms per batch of "
        f"{data.batch_size} {shapes}, beside {step_ms:.1f} ms per step")
    del harness, state, data, ldm
    log(f"[ldm train concat] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def classifier_main_path(tree: dict) -> dict:
    """[classifier]: NoisyLatentClassifierTrainer over VQ-f4 latents of the
    ImageNet tree with their class labels, its EncoderUNetModel derived from
    the LSUN LDM's UNet params as the reference's NoisyLatentImageClassifier
    derives it (in_channels the UNet's out_channels, 1000 classes,
    pool attention); then one classifier_guidance_corrector call."""
    from sd_tpu_torch.core.schedules import DiffusionSchedule, q_sample
    from sd_tpu_torch.data.base import DataLoader
    from sd_tpu_torch.data.imagenet import ImageNetTrain
    from sd_tpu_torch.models.encoder_unet import EncoderUNetConfig, EncoderUNetModel
    from sd_tpu_torch.training.classifier import (NoisyLatentClassifierTrainer,
                                                  classifier_guidance_corrector)
    from sd_tpu_torch.utils import config as C

    t_phase = time.perf_counter()
    model_cfg = C.load_yaml(LSUN_CONFIG)["model"]["params"]
    device = torch.device("cuda")
    with torch.device("meta"):
        vq = C.instantiate_from_config(model_cfg["first_stage_config"])
        unet_p = dict(model_cfg["unet_config"]["params"])
        unet_p.update(in_channels=unet_p["out_channels"], out_channels=IMAGENET_CLASSES,
                      pool="attention")
        model = EncoderUNetModel(EncoderUNetConfig.from_dict(unet_p))
    generator = torch.Generator(device).manual_seed(0)
    for module in (vq, model):
        module.to_empty(device=device)
        C.init_random_(module, generator)
    vq = vq.to(torch.bfloat16).eval().requires_grad_(False)
    schedule = DiffusionSchedule.create(
        timesteps=1000, linear_start=model_cfg["linear_start"],
        linear_end=model_cfg["linear_end"])
    trainer = NoisyLatentClassifierTrainer(
        model=model, schedule=schedule,
        encode_fn=lambda x, g: vq.encode_pre_quant(x.to(torch.bfloat16)))
    state = trainer.init_state()
    loader = DataLoader(ImageNetTrain(data_root=tree["imagenet"], size=256),
                        batch_size=CLASSIFIER_BATCH, shuffle=True)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[classifier] EncoderUNetModel from {LSUN_CONFIG}'s UNet params (in_channels 3, "
        f"{IMAGENET_CLASSES} classes, pool attention), {n_params / 1e6:.1f}M parameters in fp32 "
        f"(AdamW, bf16 autocast), frozen VQ-f4 encoder in bf16; batch {CLASSIFIER_BATCH} of "
        f"256² ImageNet crops; {DATA_STEPS} steps")
    torch.cuda.reset_peak_memory_stats()
    times, total = [], {}
    for step in range(DATA_STEPS):
        batch = loader.batch(step)
        reset_launches()
        t0 = time.perf_counter()
        logs = trainer.train_step(state, batch, torch.Generator(device).manual_seed(step))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = read_launches()
        logs = {k: float(v) for k, v in logs.items()}
        log(f"[classifier] step {state.step}: {logs}, {times[-1] * 1e3:.1f} ms, launches {counts}")
        if not all(np.isfinite(v) for v in logs.values()):
            raise AssertionError(f"[classifier] step {state.step}: {logs}")
        if counts != expect(**CLASSIFIER_LAUNCHES):
            raise AssertionError(f"[classifier] launches {counts} != {CLASSIFIER_LAUNCHES}")
        total = add_counts(total, counts)
    log(f"[classifier] {DATA_STEPS} steps: {' '.join(f'{t * 1e3:.1f}' for t in times)} ms; "
        f"peak memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # one guidance call at t = 500 on latents of the last batch, as a sampler makes it
    x, labels = trainer.inputs(batch)
    t = torch.full((x.shape[0],), 500, dtype=torch.long, device=device)
    e_t = torch.randn(x.shape, generator=generator, device=device)
    x_t = q_sample(schedule, x, t, e_t)
    corrector = classifier_guidance_corrector(state.model.eval(), schedule, labels, scale=1.0)
    reset_launches()
    with torch.no_grad(), trainer.autocast():
        shifted = corrector(e_t, x_t, t, None)
    torch.cuda.synchronize()
    counts = read_launches()
    moved = float((shifted.float() - e_t).abs().max())
    log(f"[classifier] classifier_guidance_corrector at t = 500: eps shifted by at most "
        f"{moved:.3e}; launches {counts}")
    if (shifted.shape != e_t.shape or not torch.isfinite(shifted).all() or not moved > 0
            or counts != expect(**CORRECTOR_LAUNCHES)):
        raise AssertionError(f"[classifier] corrector: {tuple(shifted.shape)}, moved {moved}, "
                             f"launches {counts}")
    total = add_counts(total, counts)
    del trainer, state, model, vq
    log(f"[classifier] phase {time.perf_counter() - t_phase:.1f} s")
    return total


# the dry run's names for the launch counters it reports
DRYRUN_COUNTERS = {"K1": "flash_attention", "K2": "geglu_ff", "K3": "flash_attention_bwd"}
# one UNet evaluation of SD v1, and PLMS 50 with guidance: a rank's K1 and K2
TP_EVAL_LAUNCHES = {"K1": SITES_PER_UNET, "K2": SITES_PER_UNET, "K3": 0}
SAMPLE_LAUNCHES = {"K1": SITES_PER_UNET * EVALS["plms"](STEPS),
                   "K2": SITES_PER_UNET * EVALS["plms"](STEPS), "K3": 0}
PARALLEL_TIMEOUT = 600


def run_ranks(label: str, nproc: int, backend: str, legs: str, steps: int) -> list:
    """``scripts/dryrun_multigpu.py`` on ``nproc`` ranks through
    ``torch.distributed.run`` (SD v1, global batch 4): its output logged, a
    non-zero exit a failure; returns each rank's DRYRUN record in rank order.
    The ranks run in a session of their own, killed whole at the time limit."""
    root = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            str(nproc), "-m", "sd_tpu_torch.scripts.dryrun_multigpu", "--backend", backend,
            "--legs", legs, "--batch", "4", "--steps", str(steps)]
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1"}
    log(f"[{label}] {' '.join(argv[1:])}")
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=PARALLEL_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
    rows = []
    for line in out.splitlines():
        if line.startswith("DRYRUN "):
            rows.append(json.loads(line[len("DRYRUN "):]))
        elif line.startswith("[dryrun") or "Error" in line or "error" in line:
            log(f"[{label}]   {line}")
    log(f"[{label}] {nproc} rank(s) exited {proc.returncode} after "
        f"{time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0 or len(rows) != nproc:
        log("\n".join(out.splitlines()[-60:]))
        raise AssertionError(f"[{label}] exit code {proc.returncode}, {len(rows)} of {nproc} "
                             f"records")
    return sorted(rows, key=lambda r: r["rank"])


def check_train_leg(label: str, rows: list, note: str = "") -> dict:
    """Every rank's per-step launches exactly TRAIN_LAUNCHES; logs the ms
    per step with and without DDP, the gap to one process and the peak
    memory; returns the launches summed over ranks and steps."""
    want = {k: TRAIN_LAUNCHES.get(name, 0) for k, name in DRYRUN_COUNTERS.items()}
    total = dict.fromkeys(DRYRUN_COUNTERS, 0)
    for r in rows:
        leg = r["train"]
        for step, counts in enumerate(leg["launches"], 1):
            if counts != want:
                raise AssertionError(f"[{label}] rank {r['rank']} step {step}: launches "
                                     f"{counts} != {want}")
            total = {k: total[k] + counts[k] for k in total}
        z = leg["zero"]
        log(f"[{label}] rank {r['rank']}: DDP + ZeRO-1 steps {' '.join(f'{t:.1f}' for t in leg['ms'])} "
            f"ms{note}, losses {' '.join(f'{x:.5f}' for x in leg['loss'])}, peak memory "
            f"{leg['peak_gib']:.2f} GiB, moments owned {z['owned_bytes'] / 2**30:.3f} GiB of a "
            f"share of {z['share_bytes'] / 2**30:.3f}, EMA tensors {z['ema_tensors']} of "
            f"{z['tensors']}; launches a step {want}")
    ref = rows[0]["train"]
    log(f"[{label}] one process at batch 4 (no DDP, no ZeRO): "
        f"{' '.join(f'{t:.1f}' for t in ref['reference_ms'])} ms, peak memory "
        f"{ref['reference_peak_gib']:.2f} GiB; against it: AdamW's first moments relative L2 "
        f"{ref['moment_rel_l2']:.3e}, the deltas' {ref['delta_rel_l2']:.3e}, parameters max "
        f"abs {ref['max_abs']:.3e}, EMA max abs {ref['ema_max_abs']:.3e}")
    return total


# the first_stage leg's exact gaps at one rank, and its launches a step and rank
FIRST_STAGE_GAPS = ("moment_rel_l2", "delta_rel_l2", "max_abs", "stats_rel_l2", "logvar_gap")
FIRST_STAGE_DP_LAUNCHES = {k: FIRST_STAGE_LAUNCHES.get(name, 0)
                           for k, name in DRYRUN_COUNTERS.items()}


def check_first_stage_leg(label: str, rows: list, note: str = "") -> dict:
    """The first_stage leg of every rank: exactly FIRST_STAGE_LAUNCHES each
    step, against the one-process reference within the dry run's bounds
    (every gap 0 at one rank, which the dry run also raises on); logs the
    ms a step with and without DDP, the peak memory and the gaps; returns
    the launches summed over ranks, models and steps."""
    total = dict.fromkeys(DRYRUN_COUNTERS, 0)
    n = len(rows)
    # the leg's records by model (beside its "leg_s")
    models = {k: v for k, v in rows[0]["first_stage"].items() if isinstance(v, dict)}
    if sorted(models) != ["kl", "vq"]:
        raise AssertionError(f"[{label}] first_stage ran {sorted(models)}, not kl and vq")
    for kind, ref in models.items():
        for r in rows:
            leg = r["first_stage"][kind]
            for step, counts in enumerate(leg["launches"], 1):
                if counts != FIRST_STAGE_DP_LAUNCHES:
                    raise AssertionError(f"[{label}] {kind} rank {r['rank']} step {step}: "
                                         f"launches {counts} != {FIRST_STAGE_DP_LAUNCHES}")
                total = {k: total[k] + counts[k] for k in total}
            zero = ", ".join(f"{part} moments owned {z['owned_bytes'] / 2**20:.1f} MiB of a "
                             f"share of {z['share_bytes'] / 2**20:.1f}"
                             for part, z in leg.get("zero", {}).items())
            log(f"[{label}] {kind} rank {r['rank']}: {leg['batch'] // n} images a rank, DDP"
                f"{' + ZeRO-1' if n > 1 else ''} steps {' '.join(f'{t:.1f}' for t in leg['ms'])} "
                f"ms{note}, losses {' '.join(f'{x:.5g}' for x in leg['loss'])}, d_weight "
                f"{' '.join(f'{x:.4g}' for x in leg['d_weight'])}, disc_loss "
                f"{' '.join(f'{x:.4g}' for x in leg['disc_loss'])}, peak memory "
                f"{leg['peak_gib']:.2f} GiB{', ' + zero if zero else ''}; launches a step "
                f"{FIRST_STAGE_DP_LAUNCHES}")
        if not ref["ok"] or (n == 1 and any(ref[k] != 0 for k in FIRST_STAGE_GAPS)):
            raise AssertionError(f"[{label}] {kind} against one process: {ref}")
        log(f"[{label}] {kind}: the reference of {n} rank(s) in one process at batch "
            f"{ref['batch']}: {' '.join(f'{t:.1f}' for t in ref['reference_ms'])} ms, peak memory "
            f"{ref['reference_peak_gib']:.2f} GiB; against it: the first moments relative L2 "
            f"{ref['moment_rel_l2']:.3e}, the deltas' {ref['delta_rel_l2']:.3e}, parameters "
            f"max abs {ref['max_abs']:.3e}, running statistics {ref['stats_rel_l2']:.3e}, logvar "
            f"gap {ref['logvar_gap']:.3e}" + (" (every gap 0)" if n == 1 else ""))
    return total


def parallel_main_paths() -> list:
    """[parallel nccl] and [parallel 2 ranks, one card]: the dry run of the
    port's parallelism at SD v1 full width and of the first stages' data
    parallelism at full width; returns the ranks' launches."""
    t_phase = time.perf_counter()
    rows = run_ranks("parallel nccl", 1, "nccl", "train,first_stage", 3)
    runs = [check_train_leg("parallel nccl", rows), check_first_stage_leg("parallel nccl", rows)]
    free_memory()
    rows = run_ranks("parallel 2 ranks, one card", 2, "gloo", "train,first_stage,sample,tp,hsdp",
                     2)
    label = "parallel 2 ranks, one card"
    gloo = " (gloo's collectives through the host: no speed figure)"
    runs.append(check_train_leg(label, rows, gloo))
    runs.append(check_first_stage_leg(label, rows, gloo))
    for r in rows:
        sample, tp, hsdp = r["sample"], r["tp"], r["hsdp"]
        if sample["launches"] != SAMPLE_LAUNCHES:
            raise AssertionError(f"[{label}] rank {r['rank']} sharded_sample launches "
                                 f"{sample['launches']} != {SAMPLE_LAUNCHES}")
        if (tp["launches"] != TP_EVAL_LAUNCHES or tp["replicated_launches"] != TP_EVAL_LAUNCHES
                or tp["all_reduces"] != tp["boundaries"]):
            raise AssertionError(f"[{label}] rank {r['rank']} tp: {tp}")
        runs += [sample["launches"], tp["launches"]]
        log(f"[{label}] rank {r['rank']}: sharded_sample PLMS {STEPS} at 4 of a batch of 8 "
            f"{sample['s']:.2f} s{gloo}, launches {sample['launches']}; tp UNet at B=2: "
            f"{tp['sharded_tensors']} tensors sharded, {tp['all_reduces']} all-reduces for "
            f"{tp['boundaries']} row-parallel boundaries, relative L2 {tp['rel_l2']:.3e}, "
            f"launches {tp['launches']} (replicated {tp['replicated_launches']}); hsdp "
            f"{'ran' if hsdp['ran'] else 'not run: ' + hsdp.get('refused', hsdp.get('reason'))}")
    log(f"[{label}] one process samples the batch of 8 in {rows[0]['sample']['single_s']:.2f} "
        f"s; the sharded latents against it: relative L2 {rows[0]['sample']['rel_l2']:.3e}")
    log(f"[parallel] phases {time.perf_counter() - t_phase:.1f} s")
    return [{DRYRUN_COUNTERS[k]: v for k, v in run.items()} for run in runs]


# [convergence]: sd_tpu_torch.scripts.convergence_run on convergence-shapes.yaml
# at full width (32², batch 8) for CONVERGENCE_STEPS of the JAX tool's 2250
# steps, then int8_quality on run A and int8_quality --flagship at
# FLAGSHIP_STEPS DDIM steps. The cut: on an H100 a step took 98-140 ms (the
# image logs in) and int8_quality 58-71 s, and at 400 steps the phase took
# 199-262 s; 300 steps reduce the smoothed loss by 55.79% (the runs are
# deterministic: every card run read the same curve), past the gate's 50%,
# and 53.73 dB in int8_quality, past its 30
CONVERGENCE_STEPS = 300
FLAGSHIP_STEPS = 8
# SpatialTransformer blocks of convergence-shapes.yaml's UNet (the 16² level's
# input and two output blocks, and the middle block): K1 and K2 a UNet
# evaluation; the image logger's DDIM steps and its batch
PROBE_SITES = 4
LOGGER_STEPS = 20
# the flagship leg at 2 samples with guidance (B=4), a UNet evaluation a
# step: bf16 runs K1 and K2 at SD v1's 16 sites; int8 "all" runs K5 at the 5
# sites at 64² and K1 at the other 11, K4 at the 10 FF sites of 32² and 16²
# (M = 4096 and 1024 pass its M >= 1024 gate; the middle block's 256 and the
# 64² level's inner 1280 do not) and K2 at the other 6
FLAGSHIP_LAUNCHES = {"flash_attention": (SITES_PER_UNET + 11) * FLAGSHIP_STEPS,
                     "geglu_ff": (SITES_PER_UNET + 6) * FLAGSHIP_STEPS,
                     "flash_attention_int8": 5 * FLAGSHIP_STEPS,
                     "geglu_ff_int8": 10 * FLAGSHIP_STEPS}


def logger_firings(first: int, last: int, every: int = 750) -> int:
    """The image logger's firings over the steps first..last (its default
    cadence: steps 1, 2, 4 and 8, and every ``every``)."""
    return sum(1 for s in range(first, last + 1) if s % every == 0 or s in (1, 2, 4, 8))


def conv3x3_sites(model_cfg: dict) -> int:
    """The Conv3x3 modules of a config's UNet (built on the meta device)."""
    from sd_tpu_torch.ops.conv import Conv3x3
    from sd_tpu_torch.utils.config import build_latent_diffusion

    ldm = build_latent_diffusion(model_cfg, device="meta")
    return sum(isinstance(m, Conv3x3) for m in ldm.model.diffusion_model.modules())


def convergence_main_path() -> dict:
    """[convergence]: the convergence run (kill and exact resume), the int8
    quality gate on the model it trained and the flagship int8 agreement;
    returns the launches (the training runs' from the lines they print; the
    killed run's are not counted)."""
    with tempfile.TemporaryDirectory(prefix="convergence_") as d:
        return _convergence(d)


def _convergence(d: str) -> dict:
    from sd_tpu_torch.scripts import convergence_run, int8_quality
    from sd_tpu_torch.utils.checkpoint import run_config_path
    from sd_tpu_torch.utils.config import SD_V1_MODEL_CONFIG, load_yaml

    S = CONVERGENCE_STEPS
    log(f"[convergence] python -m sd_tpu_torch.scripts.convergence_run --steps {S}: "
        f"configs/sd_tpu/convergence-shapes.yaml at full width (32², batch 8, seed 23), run A "
        f"uninterrupted, run B sent SIGUSR1 past step {S // 2}, SIGKILLed and resumed, each in "
        f"a process of its own on the card (cut: {S} of the JAX tool's 2250 steps, since a "
        f"step took 98-140 ms on an H100 and this phase 199-262 s at 400 steps)")
    out, runs = os.path.join(d, "out"), os.path.join(d, "runs")
    t0 = time.perf_counter()
    rc = convergence_run.main(["--steps", str(S), "--out", out, "--workdir", runs])
    seconds = time.perf_counter() - t0
    with open(os.path.join(out, "resume_report.json")) as f:
        report = json.load(f)
    gaps = report["resume_max_abs_diff"]
    log(f"[convergence] {seconds:.1f} s; run A {report['runA_seconds']} s, "
        f"{report['runA_ms_per_step']} ms a step (the image logger in); smoothed loss "
        f"{report['loss_first_smoothed']} -> {report['loss_final_smoothed']} "
        f"({report['loss_reduction_pct']}% reduction, bound > 50%); melk at step "
        f"{report['melk_step']}; resume gaps {gaps}; the last losses equal: "
        f"{report['runB_losses_match_runA']}; exit code {rc}")
    if report["loss_reduction_pct"] <= 50 or any(v != 0.0 for v in gaps.values()):
        raise AssertionError(f"[convergence] loss reduction {report['loss_reduction_pct']}% "
                             f"or resume gaps {gaps}")
    if not report["runB_losses_match_runA"] or rc != 0:
        raise AssertionError(f"[convergence] the resumed run's last losses differ (or exit "
                             f"code {rc})")
    melk = report["melk_step"]
    totals = {}
    for run, (first, last) in (("runA", (1, S)), ("runB_resumed", (melk + 1, S))):
        got = report["launches"][run]
        each = PROBE_SITES * ((last - first + 1) + LOGGER_STEPS * logger_firings(first, last))
        want = dict.fromkeys(got, 0)
        want.update(flash_attention=each, geglu_ff=each)
        log(f"[convergence] {run}'s launches (steps {first}-{last}): {got}")
        if got != want:
            raise AssertionError(f"[convergence] {run}: launches {got}, expected {want}")
        totals = add_counts(totals, got)

    run_a = convergence_run.find_logdir(runs, "runa")
    reset_launches()
    t0 = time.perf_counter()
    rep = int8_quality.quality(run_a, out)
    counts = read_launches()
    model_cfg = load_yaml(run_config_path(run_a))["model"]
    convs = conv3x3_sites(model_cfg)
    chain = model_cfg["params"]["timesteps"]  # the ancestral chain's evaluations an arm
    log(f"[convergence] int8_quality ({rep['mode']}, {time.perf_counter() - t0:.1f} s): PSNR "
        f"{rep['int8_vs_bf16_psnr_db']} dB (gate >= 30), bf16 {rep['bf16']}, int8 "
        f"{rep['int8']}; gate {'passed' if rep['pass'] else 'not passed'}; launches {counts}")
    if counts != expect(flash_attention=2 * chain * PROBE_SITES,
                        geglu_ff=2 * chain * PROBE_SITES, int8_conv3x3=chain * convs):
        raise AssertionError(f"[convergence] int8_quality's launches {counts}")
    # the card's runs pass the gate at this S (53.73 dB at 300 steps)
    if not rep["pass"]:
        raise AssertionError(f"[convergence] int8_quality's gate failed: {rep}")
    totals = add_counts(totals, counts)

    reset_launches()
    t0 = time.perf_counter()
    flagship = int8_quality.flagship_agreement(FLAGSHIP_STEPS, out)
    counts = read_launches()
    log(f"[convergence] int8_quality --flagship --steps {FLAGSHIP_STEPS} "
        f"({time.perf_counter() - t0:.1f} s): relative L2 {flagship['latent_rel_l2']} (bound "
        f"{AGREEMENT_TOL}); launches {counts}")
    want = expect(**FLAGSHIP_LAUNCHES,
                  int8_conv3x3=FLAGSHIP_STEPS * conv3x3_sites(SD_V1_MODEL_CONFIG))
    if counts != want:
        raise AssertionError(f"[convergence] the flagship leg's launches {counts}, expected "
                             f"{want}")
    return add_counts(totals, counts)


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = check_device()
    build()
    timings = check_kernels()
    timings.update(check_int8_kernels())
    timings.update(check_conv_kernels())
    free_memory()
    timings.update(check_block_kernels())
    check_reference()
    check_fp32_reference()
    free_memory()
    check_int8_reference()
    check_conv_modes_reference()
    x3_launches = x3_experiment()
    block_launches = block_experiment()
    free_memory()
    served, pipe = serve_main_path()
    served_conv = serve_conv_modes(pipe, served)
    del pipe
    free_memory()
    served_int8 = serve_int8(served)
    free_memory()
    served_ckpt = serve_from_checkpoint()
    free_memory()
    served_img2img = img2img_main_path()
    served_daemon = serve_daemon()
    free_memory()
    check_training_reference()
    free_memory()
    trained, served_run = train_main_path()
    free_memory()
    first_stage = first_stage_main_path()
    free_memory()
    trained_1p4b = ldm_1p4b_main_path()
    free_memory()
    inpainted = inpaint_main_path()
    sampled = sample_diffusion_main_path()
    free_memory()
    cin256 = cin256_main_path()
    superres = superres_main_path()
    free_memory()
    knn = knn2img_main_path()
    extras = vae_extras_main_path()
    free_memory()
    data_runs = data_main_paths()
    free_memory()
    parallel_runs = parallel_main_paths()
    free_memory()
    converged = convergence_main_path()
    source = {"flash_attention": ("sd_tpu_torch/csrc/flash_attention.cu",
                                  "sd_tpu/ops/pallas/flash_attention.py:324"),
              "geglu_ff": ("sd_tpu_torch/csrc/geglu_ff.cu",
                           "sd_tpu/ops/pallas/geglu_ff.py:255"),
              "flash_attention_bwd": ("sd_tpu_torch/csrc/flash_attention_bwd.cu",
                                      "sd_tpu/ops/pallas/flash_attention.py:490"),
              "geglu_ff_int8": ("sd_tpu_torch/csrc/geglu_ff_int8.cu",
                                "sd_tpu/ops/pallas/geglu_ff.py:313"),
              "flash_attention_int8": ("sd_tpu_torch/csrc/flash_attention_int8.cu",
                                       "sd_tpu/ops/pallas/flash_attention.py:225"),
              "int8_dense": ("sd_tpu_torch/csrc/int8_dense.cu",
                             "sd_tpu/ops/pallas/int8_dense.py:66"),
              "fused_conv3x3": ("sd_tpu_torch/csrc/fused_conv.cu",
                                "sd_tpu/ops/pallas/fused_conv.py:300"),
              "winograd_conv3x3": ("sd_tpu_torch/csrc/winograd_conv.cu",
                                   "sd_tpu/ops/pallas/winograd_conv.py:174"),
              "winograd_conv3x3_split": ("sd_tpu_torch/csrc/winograd_conv.cu",
                                         "tools/exp_winograd.py:271"),
              "fused_block": ("sd_tpu_torch/csrc/fused_block.cu", "tools/exp_block_kernel.py:91"),
              "tail_fused": ("sd_tpu_torch/csrc/tail_fused.cu", "tools/exp_block_kernel.py:244")}
    runs = (served["launches"], served_int8, trained, served_conv, x3_launches, block_launches,
            served_ckpt, served_run, served_img2img, served_daemon, first_stage, trained_1p4b,
            inpainted, sampled, cin256, superres, knn, extras, *data_runs, *parallel_runs,
            converged)
    kernels = []
    for k, rows in timings.items():
        # the times sum the timed shapes; the error is the worst of all
        timed = [r for r in rows if "ms" in r]
        library = [r["library_ms"] for r in timed]
        ops_ms = sum(r["bound_ms"] for r in timed if r["bound_by"] == "operations")
        kernels.append({
            "name": k, "route": "cuda", "source": source[k][0], "replaces": source[k][1],
            "launches": sum(run.get(k, 0) for run in runs),
            "max_abs_err": max(r["err"] for r in rows),
            "ms": sum(r["ms"] for r in timed), "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": "operations" if 2 * ops_ms >= sum(r["bound_ms"] for r in timed)
            else "bytes",
            "library_ms": None if None in library else sum(library)})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
