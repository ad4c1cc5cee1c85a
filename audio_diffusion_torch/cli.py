"""Command-line interface: train on a directory of WAVs, sample to WAVs,
describe a run (counterpart of audio_diffusion_tpu/cli.py)::

    python -m audio_diffusion_torch train --data wavs/ --preset \\
        UNCONDITIONAL_48K --steps 100000 --batch 8 --crop 262144 \\
        --out run1/
    python -m audio_diffusion_torch sample --model run1/model --num 4 \\
        --steps 25 --sampler dpm --length 262144 --out samples/
    python -m audio_diffusion_torch info --run run1/ --params
    python -m audio_diffusion_torch serve --model run1/model --port 8000
    python -m audio_diffusion_torch export --model run1/model --out art/
    python -m audio_diffusion_torch serve --model run1/model --artifact art/
    python -m audio_diffusion_torch distill --model run1/model --data wavs/ \\
        --base-steps 64 --target-steps 8
    python -m audio_diffusion_torch eval --ref wavs/ --samples samples/

``--preset`` is a name from :mod:`audio_diffusion_torch.presets` or a path to
a JSON file of UNetV0/DiffusionModel kwargs. The run directory holds
``config.json`` (the resolved config, with the same recorded keys as the
JAX CLI's), ``ckpts/<step>`` (the Trainer's checkpoints) and ``model`` (the
port's ``model.save`` file; ``--init-from`` takes such a file), and
``model_distilled<steps>`` for each ``distill`` run. Every command but
``eval`` (numpy on the host) runs on the CUDA card unless ``--device`` says
otherwise (``cpu``).

``train`` and ``distill`` build a mesh over every rank (``create_mesh()``),
as the JAX CLI does: alone it is one rank and changes nothing, and under
``torchrun --nproc_per_node N python -m audio_diffusion_torch train ...``
the run is data-parallel over N cards, each rank taking its rows of every
global ``--batch``; rank 0 writes the run's files.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

__all__ = ["main"]


# Named presets this CLI can drive end-to-end, mapped to their task.
_CLI_PRESETS = {
    "UNCONDITIONAL_48K": "unconditional",
    "TEXT_CONDITIONAL_48K": "unconditional",
    "UPSAMPLER_16X": "upsampler",
    "VOCODER_48K": "vocoder",
    "AUTOENCODER_48K": "autoencoder",
}

# The reference README's diffusion-autoencoder encoder configuration — the
# CLI default; override per-key via an "_encoder" dict (+ "_inject_depth")
# in a JSON config.
_AE_ENCODER_DEFAULTS = dict(channels=512, factors=[2], num_blocks=[12],
                            out_channels=32, mel_channels=80)
_AE_INJECT_DEPTH = 6

def _resolve_config(preset: str):
    """Returns (cfg kwargs, task name). JSON configs may carry an embedded
    ``"_task"`` key (as written by `train` into config.json)."""
    from . import presets

    name = preset.upper()
    if name in _CLI_PRESETS:
        return dict(getattr(presets, name)), _CLI_PRESETS[name]
    p = Path(preset)
    if p.exists():
        cfg = json.loads(p.read_text())
        return cfg, cfg.pop("_task", "unconditional")
    if hasattr(presets, name):
        raise SystemExit(
            f"preset {preset!r} needs the Python API; this CLI drives: "
            f"{', '.join(_CLI_PRESETS)} or a JSON kwargs file")
    raise SystemExit(
        f"unknown preset {preset!r}: pass one of "
        f"[{', '.join(_CLI_PRESETS)}] or a path to a JSON file of model "
        "kwargs")


def _device(args):
    from .utils import resolve_device

    return resolve_device(args.device)


def _mesh(device):
    """The mesh of a ``train`` or ``distill`` run over every rank, and this
    rank's device (the user's alone; the launcher's card under
    ``torchrun``)."""
    from .parallel import create_mesh
    from .parallel.mesh import mesh_device

    import torch.distributed as dist

    mesh = create_mesh(device.type)
    if mesh.size() > 1:
        device = mesh_device(mesh)
    if _rank0(mesh):
        print(f"mesh: data={mesh.size(0)} x model={mesh.size(1)} over "
              f"{dist.get_backend()}")
    return mesh, device


def _rank0(mesh) -> bool:
    return mesh.get_rank() == 0


def _rank_rows(feed, mesh):
    """This rank's rows of each global batch (or ``(x, cond)`` pair) of a
    host feed that every rank reads alike; the feed itself on one data
    rank."""
    from .parallel import shard_batch
    from .parallel.mesh import axis_size

    if axis_size(mesh, "data") == 1:
        return feed
    return (shard_batch(b, mesh) for b in feed)


def _make_text_encoder(spec: Dict, cfg: Dict, device):
    """Build the text encoder a run recorded (``_text_encoder`` in
    config.json) or the user requested (train --text-encoder). Its
    max_length/features default to the net's embedding geometry."""
    from .ops import text as text_mod

    kind = spec.get("kind", "t5")
    max_length = spec.get("max_length",
                          cfg.get("embedding_max_length", 64))
    features = spec.get("features", cfg.get("embedding_features", 768))
    if kind == "t5":
        raise NotImplementedError(
            "the pretrained T5TextEncoder (t5-base) is not ported: its "
            "weights are not in the repository (ROADMAP: the pretrained T5 "
            "weights); pass --text-encoder random or stub")
    if kind == "random":
        return text_mod.RandomT5TextEncoder(max_length=max_length,
                                            features=features, device=device)
    if kind == "stub":
        return text_mod.StubTextEncoder(max_length=max_length,
                                        features=features)
    raise SystemExit(f"unknown text encoder kind {kind!r}: "
                     "pass t5, random, or stub")


def _build_model(cfg: Dict, sampler: str, device, task: str = "unconditional",
                 upsample_factor: Optional[int] = None):
    import torch

    from . import (DiffusionModel, DiffusionUpsampler, DiffusionVocoder,
                   DPMSampler, UNetV0, VSampler)

    text_spec = cfg.pop("_text_encoder", None)
    if text_spec is not None and task == "unconditional":
        cfg["text_encoder"] = _make_text_encoder(text_spec, cfg, device)

    # Compute dtype (master params stay f32 either way); configs record it
    # as a string.
    dtype = cfg.pop("_dtype", None)
    if dtype is not None:
        cfg["dtype"] = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                        "f32": None, "float32": None}[dtype]
    cfg.pop("_init_from", None)  # provenance record, not model geometry
    sampler_t = {"v": VSampler, "dpm": DPMSampler}[sampler]
    common = dict(net_t=UNetV0, device=device)
    if task == "upsampler":
        return DiffusionUpsampler(sampler_t=sampler_t,
                                  upsample_factor=upsample_factor or 16,
                                  **common, **cfg)
    if task == "vocoder":
        return DiffusionVocoder(sampler_t=sampler_t, **common, **cfg)
    if task == "autoencoder":
        from .models import DiffusionAE, MelEncoder1d

        enc_cfg = {**_AE_ENCODER_DEFAULTS, **(cfg.pop("_encoder", None)
                                              or {})}
        inject_depth = cfg.pop("_inject_depth", _AE_INJECT_DEPTH)
        encoder = MelEncoder1d(in_channels=cfg.get("in_channels", 2),
                               dtype=cfg.get("dtype"), device=device,
                               **enc_cfg)
        return DiffusionAE(sampler_t=sampler_t, encoder=encoder,
                           inject_depth=inject_depth, **common, **cfg)
    if task == "ar":
        # Autoregressive: context window + split count are model geometry;
        # sampling is ARVSampler regardless of --sampler.
        from .models import DiffusionAR

        if "_length" not in cfg:
            raise SystemExit(
                "ar configs need \"_length\" (and optionally "
                "\"_num_splits\") — train records them in the run's "
                "config.json; add them to a hand-written JSON")
        return DiffusionAR(length=cfg.pop("_length"),
                           num_splits=cfg.pop("_num_splits", 4), **common,
                           **cfg)
    assert task == "unconditional", task
    return DiffusionModel(sampler_t=sampler_t, **common, **cfg)


def _load_dataset(args, device, mesh):
    """Dataset with --data-placement semantics: "device" keeps the whole
    corpus on the card and crops batches there (no per-step uploads);
    "auto" picks device when the corpus fits comfortably (<= 1 GiB). A
    device corpus yields this rank's rows of each global batch; a host
    dataset yields the global batch in every rank (see _rank_rows)."""
    from .data import AudioDataset, DeviceCorpus

    ds = AudioDataset(args.data, crop_frames=args.crop,
                      batch_size=args.batch, seed=args.seed)
    corpus_bytes = sum(ds.frames) * ds.channels * ds.dtype.itemsize
    use_device = (args.data_placement == "device"
                  or (args.data_placement == "auto"
                      and corpus_bytes <= 1 << 30))
    if use_device:
        ds = DeviceCorpus(args.data, crop_frames=args.crop,
                          batch_size=args.batch, seed=args.seed,
                          max_bytes=max(corpus_bytes, 1 << 30),
                          mesh=mesh, device=device)
    place = (f"device-resident ({corpus_bytes/2**20:.0f} MB on "
             f"{device.type}, no per-step uploads)" if use_device
             else f"host (upload dtype {ds.dtype.name}"
             + (", lossless PCM16 passthrough)"
                if ds.dtype.name == "int16" else ")"))
    print(f"dataset: {len(ds.files)} files, {ds.channels} ch @ "
          f"{ds.sample_rate} Hz, crop {args.crop}, data {place}")
    return ds


def _missing_sidecars(ds, directory, suffix, flag):
    missing = [f.stem for f in ds.files
               if not (Path(directory) / f"{f.stem}{suffix}").exists()]
    if missing:
        raise SystemExit(
            f"{flag} is missing {suffix} for: {', '.join(missing[:5])}"
            + (f" (+{len(missing) - 5} more)" if len(missing) > 5 else ""))


def _paired_feed(ds, table):
    """Pair each crop with its file's row of ``table``: (x, {"embedding":
    ...}) tuples. ``ds`` is an AudioDataset with return_indices=True."""
    for x, idx in ds:
        yield x, {"embedding": table[idx]}


def _embedding_table(ds, embedding_dir):
    """Precomputed embeddings (DIR/<wav stem>.npy, one per corpus file) as
    one [files, tokens, features] table (train --embedding-dir)."""
    import numpy as np

    _missing_sidecars(ds, embedding_dir, ".npy", "--embedding-dir")
    return np.stack([np.load(Path(embedding_dir) / f"{f.stem}.npy").astype(
        np.float32) for f in ds.files])


def _caption_table(ds, caption_dir, encoder):
    """Sidecar captions (DIR/<wav stem>.txt, one per corpus file) encoded
    once into a [files, max_length, features] table (train
    --caption-dir)."""
    import numpy as np

    _missing_sidecars(ds, caption_dir, ".txt", "--caption-dir")
    captions = [(Path(caption_dir) / f"{f.stem}.txt").read_text().strip()
                for f in ds.files]
    return np.asarray(encoder(captions), np.float32)


def _cmd_train(args) -> None:
    from .data import AudioDataset, DeviceCorpus
    from .train import Trainer, TrainerConfig

    device = _device(args)
    if args.embedding_dir is not None and args.caption_dir is not None:
        raise SystemExit("pass --embedding-dir OR --caption-dir, not both")
    mesh, device = _mesh(device)
    if args.caption_dir is not None or args.embedding_dir is not None:
        # Per-file conditioning rides each crop as an (x, cond) tuple: host
        # data path (the table is indexed per crop on the host).
        ds = AudioDataset(args.data, crop_frames=args.crop,
                          batch_size=args.batch, seed=args.seed,
                          return_indices=True)
        what = (f"sidecar captions from {args.caption_dir} "
                f"({args.text_encoder} encoder)"
                if args.caption_dir is not None
                else f"paired embeddings from {args.embedding_dir}")
        print(f"dataset: {len(ds.files)} files, {ds.channels} ch @ "
              f"{ds.sample_rate} Hz, crop {args.crop}, {what}")
    else:
        ds = _load_dataset(args, device, mesh)
    cfg, task = _resolve_config(args.preset)
    if args.task is not None:
        task = args.task
    cfg["in_channels"] = ds.channels  # the data decides the channel count
    if task == "vocoder":
        cfg.setdefault("mel_sample_rate", ds.sample_rate)
    if task == "autoencoder":
        enc = dict(cfg.get("_encoder") or {})
        enc.setdefault("mel_sample_rate", ds.sample_rate)
        cfg["_encoder"] = enc
    if task == "ar":
        # The AR context window is the training crop.
        cfg["_length"] = args.crop
        cfg.setdefault("_num_splits", args.num_splits)
    if args.caption_dir is not None:
        if not any(cfg.get("cross_attentions") or []):
            raise SystemExit(
                "--caption-dir needs a text-conditional config "
                "(cross_attentions + embedding features — e.g. --preset "
                "TEXT_CONDITIONAL_48K or a JSON config declaring them)")
        # Record the encoder so `sample --text` rebuilds the same one.
        cfg["_text_encoder"] = {
            "kind": args.text_encoder,
            "max_length": cfg.get("embedding_max_length", 64),
            "features": cfg.get("embedding_features", 768)}
    elif cfg.get("use_text_conditioning") and args.embedding_dir is None:
        raise SystemExit(
            "this config is text-conditional: train it with --caption-dir "
            "(sidecar x.txt captions) or --embedding-dir (precomputed "
            ".npy embeddings)")
    cfg.setdefault("_dtype", args.dtype)
    model = _build_model(dict(cfg), "v", device, task, args.upsample_factor)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    write = _rank0(mesh)
    # The resolved config, so `sample` rebuilds the same model.
    recorded = {**cfg, "_sample_rate": ds.sample_rate, "_task": task}
    if task == "upsampler":
        recorded["_upsample_factor"] = args.upsample_factor or 16
    if args.init_from is not None:
        # Warm start: parameters from a saved model file; the step counter
        # and optimizer start fresh (checkpoints in --out still win).
        model.load(args.init_from)
        recorded["_init_from"] = str(args.init_from)
        print(f"warm start: params loaded from {args.init_from}")
    if write:
        (out / "config.json").write_text(json.dumps(recorded, indent=1))
    trainer = Trainer(model, TrainerConfig(
        learning_rate=args.lr, ema_decay=args.ema_decay,
        lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
        total_steps=args.steps if args.lr_schedule == "cosine" else None,
        max_grad_norm=args.max_grad_norm,
        checkpoint_dir=str(out / "ckpts"),
        checkpoint_every=args.checkpoint_every, log_every=args.log_every,
        accum_steps=args.accum_steps,
        steps_per_call=args.steps_per_call), mesh=mesh)
    resumed = trainer.restore_latest()
    remaining = args.steps
    if resumed is not None:
        # --steps is the TOTAL budget: a preempted job finishes the rest.
        remaining = max(args.steps - resumed, 0)
        print(f"resumed from step {resumed}; {remaining} steps remain")
    # The feed starts at its beginning, after a resume too.
    feed = iter(ds)
    fit_cond: Dict = {}
    if args.caption_dir is not None:
        feed = _paired_feed(ds, _caption_table(ds, args.caption_dir,
                                               model.net.text_encoder))
        fit_cond["embedding_mask_proba"] = args.embedding_mask_proba
    elif args.embedding_dir is not None:
        feed = _paired_feed(ds, _embedding_table(ds, args.embedding_dir))
        # CFG training: drop the embedding at this rate so the null
        # branch learns.
        fit_cond["embedding_mask_proba"] = args.embedding_mask_proba
    if not isinstance(ds, DeviceCorpus):
        feed = _rank_rows(feed, mesh)
    trainer.fit(feed, num_steps=remaining, **fit_cond)
    if args.ema_decay is not None:
        import torch

        # Export the EMA weights (sampling quality) as the saved model.
        with torch.no_grad():
            for name, p in model.params.items():
                p.copy_(trainer.ema_params[name])
    if write:
        model.save(out / "model")
        print(f"saved model params to {out / 'model'}")


def _load_run_config(args):
    """Resolve ``(cfg, task, sample_rate, upsample_factor)`` from --preset
    or the run's config.json (written by `train` next to the model file).
    Bookkeeping keys are consumed here, leaving cfg as model kwargs (plus
    ``_dtype``, which `_build_model` consumes)."""
    run_cfg = Path(args.model).parent / "config.json"
    recorded = json.loads(run_cfg.read_text()) if run_cfg.exists() else {}
    if args.preset is not None:
        cfg, task = _resolve_config(args.preset)
    elif recorded:
        cfg = dict(recorded)
        task = cfg.pop("_task", "unconditional")
    else:
        raise SystemExit(
            f"no {run_cfg} next to the model file — pass --preset "
            "(the config used for training)")
    rec_rate = cfg.pop("_sample_rate", None) or recorded.get("_sample_rate")
    sample_rate = getattr(args, "sample_rate", None) or rec_rate or 48000
    upsample_factor = (cfg.pop("_upsample_factor", None)
                       or recorded.get("_upsample_factor"))
    cfg.setdefault("_dtype", args.dtype)
    return cfg, task, sample_rate, upsample_factor


def _cmd_sample(args) -> None:
    import numpy as np
    import torch

    from .data import wav_read, wav_write

    device = _device(args)
    cfg, task, sample_rate, upsample_factor = _load_run_config(args)
    if task != "unconditional":
        # Refuse, rather than silently ignore, unconditional-only flags.
        bad = [f for f, v in [("--embedding", args.embedding),
                              ("--text", args.text),
                              ("--inpaint", args.inpaint),
                              ("--total-length", args.total_length)]
               if v is not None]
        if bad:
            raise SystemExit(f"{', '.join(bad)} only appl"
                             f"{'y' if len(bad) > 1 else 'ies'} to "
                             f"unconditional models (this run is {task})")
    if args.in_channels is not None:
        cfg["in_channels"] = args.in_channels
    model = _build_model(cfg, args.sampler, device, task, upsample_factor)
    c = cfg.get("in_channels", 2)
    model.load(args.model)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    def write(dest, audio):
        wav_write(dest, audio.float().cpu().numpy(), sample_rate)

    if task == "ar":
        # Autoregressive generation: --chunks windows of length/num_splits
        # frames each.
        audio = model.sample(num_items=args.num, num_chunks=args.chunks,
                             num_steps=args.steps, generator=generator)
        for i in range(args.num):
            write(out / f"ar_{args.seed}_{i}.wav", audio[i])
        print(f"wrote {args.num} AR samples ({audio.shape[-1]} frames = "
              f"{args.chunks} chunks, {args.steps}-step ladder, "
              f"{sample_rate} Hz) to {out}")
        return

    if task in ("upsampler", "vocoder", "autoencoder"):
        need = {"upsampler": "the low-rate WAV to upsample",
                "vocoder": "a WAV whose mel spectrogram to re-vocode",
                "autoencoder": "a WAV to round-trip through the latent"}
        if args.input is None:
            raise SystemExit(f"{task} sampling needs --input ({need[task]})")
        ref = torch.from_numpy(wav_read(args.input))[None].to(device)
        stem = Path(args.input).stem
        if task == "upsampler":
            audio = model.sample(ref, generator=generator,
                                 num_steps=args.steps)
            dest, what = out / f"upsampled_{stem}.wav", (
                f"{ref.shape[-1]} -> {audio.shape[-1]} frames")
        elif task == "vocoder":
            with torch.inference_mode():
                spec = model.to_spectrogram(ref)  # [1, c, f, l]
            audio = model.sample(spec, generator=generator,
                                 num_steps=args.steps)
            dest, what = out / f"vocoded_{stem}.wav", (
                f"mel {tuple(spec.shape)} -> {audio.shape[-1]} frames")
        else:
            latent = model.encode(ref)
            audio = model.decode(latent, generator=generator,
                                 num_steps=args.steps)
            dest, what = out / f"reconstructed_{stem}.wav", (
                f"latent {tuple(latent.shape)} -> {audio.shape[-1]} frames")
        write(dest, audio[0])
        print(f"wrote {dest} ({what}, {args.steps}-step {args.sampler}, "
              f"{sample_rate} Hz)")
        return

    # Conditioning: --text encodes a caption through the run's recorded
    # text encoder; --embedding loads precomputed .npy arrays. Both feed
    # embedding=, so every path below conditions identically.
    cond = {}
    if args.text is not None and args.embedding is not None:
        raise SystemExit("pass --text OR --embedding, not both")
    if args.text is not None:
        encoder = getattr(model.net, "text_encoder", None)
        if encoder is None:
            raise SystemExit(
                "--text needs a text-conditional run (train with "
                "--caption-dir, or a config with use_text_conditioning "
                "and a recorded _text_encoder)")
        emb = np.repeat(np.asarray(encoder([args.text]), np.float32),
                        args.num, 0)
    elif args.embedding is not None:
        emb = np.load(args.embedding).astype(np.float32)
        if emb.ndim == 2:  # [tokens, features] -> same text for every sample
            emb = np.repeat(emb[None], args.num, 0)
        if emb.shape[0] != args.num:
            raise SystemExit(
                f"--embedding batch {emb.shape[0]} != --num {args.num} "
                "(pass [tokens, features] to broadcast)")
    elif args.embedding_scale is not None:
        raise SystemExit("--embedding-scale needs --embedding or --text")
    if args.text is not None or args.embedding is not None:
        cond["embedding"] = torch.from_numpy(emb).to(device)
        if args.embedding_scale is not None:
            cond["embedding_scale"] = args.embedding_scale

    if args.inpaint is not None:
        # RePaint inpainting: the frames in [--mask-start, --mask-end) are
        # regenerated, the rest kept and harmonized via --resamples.
        from .longform import make_inpainter

        if args.num != 1:
            raise SystemExit("--inpaint processes one file (--num 1); "
                             "run per-seed invocations for variants")
        src = wav_read(args.inpaint)
        a, b = args.mask_start, args.mask_end
        if a is None or b is None:
            raise SystemExit("--inpaint needs --mask-start and --mask-end")
        if not 0 <= a < b <= src.shape[-1]:
            raise SystemExit(
                f"--mask-start/--mask-end must satisfy 0 <= start < end "
                f"<= {src.shape[-1]} (the input length); got {a}:{b}")
        mask = np.ones(src.shape, bool)
        mask[..., a:b] = False  # True = keep; the gap is regenerated
        with torch.inference_mode():
            audio = make_inpainter(model).sample(
                model.params, generator,
                torch.from_numpy(src)[None].to(device),
                torch.from_numpy(mask)[None].to(device),
                num_steps=args.steps, num_resamples=args.resamples, **cond)
        dest = out / f"inpainted_{Path(args.inpaint).stem}.wav"
        write(dest, audio[0])
        print(f"wrote {dest} (regenerated [{a}:{b}) of {src.shape[-1]} "
              f"frames, {args.steps}-step RePaint x{args.resamples}, "
              f"{sample_rate} Hz)")
        return

    if args.total_length is not None and args.total_length > args.length:
        # Long-form: chain RePaint-outpainted windows past the training
        # crop; one generator drives the whole batch.
        from .longform import generate_long

        overlap = args.overlap or max(1, args.length // 4)
        audio = generate_long(
            model, length=args.total_length, window=args.length,
            overlap=overlap, num_steps=args.steps,
            num_resamples=args.resamples, generator=generator,
            batch_size=args.num, **cond)
        for i in range(args.num):
            write(out / f"long_{args.seed}_{i}.wav", audio[i])
        print(f"wrote {args.num} long-form samples ({args.total_length} "
              f"frames = {args.total_length / sample_rate:.1f} s, "
              f"window {args.length}, overlap {overlap}, {args.steps}-step) "
              f"to {out}")
        return

    # One batch for all requested samples; each sample's noise derives from
    # its own seed, as in the JAX CLI.
    noise = np.stack([
        np.random.default_rng(args.seed + i).standard_normal(
            (c, args.length)).astype(np.float32)
        for i in range(args.num)])
    audio = model.sample(torch.from_numpy(noise).to(device),
                         num_steps=args.steps, **cond)
    for i in range(args.num):
        write(out / f"sample_{args.seed + i}.wav", audio[i])
    print(f"wrote {args.num} samples ({args.steps}-step "
          f"{args.sampler}, {sample_rate} Hz) to {out}")


def _cmd_info(args) -> None:
    """Describe a training run: recorded config, geometry, checkpoints and,
    with --params, the parameter count."""
    import numpy as np

    run = Path(args.run)
    cfg_path = run / "config.json"
    if not cfg_path.exists():
        raise SystemExit(f"no config.json under {run} — is this a run "
                         "directory written by `train`?")
    recorded = json.loads(cfg_path.read_text())
    cfg = dict(recorded)
    task = cfg.pop("_task", "unconditional")
    sr = cfg.pop("_sample_rate", None)
    cfg.pop("_upsample_factor", None)
    dtype = cfg.pop("_dtype", None)

    print(f"run: {run}")
    print(f"task: {task}   sample_rate: {sr}   compute dtype: "
          f"{dtype or 'f32'}")
    chs = cfg.get("channels")
    if chs is not None:
        factors = cfg.get("factors", [])
        print(f"net: {len(chs)}-level U-Net, channels {chs}")
        if factors:
            print(f"     factors {factors} (total downsampling "
                  f"x{int(np.prod(factors))})")
        att = cfg.get("attentions")
        if att:
            print(f"     attention at levels "
                  f"{[i for i, a in enumerate(att) if a]}")
    ckpts = run / "ckpts"
    if ckpts.exists():
        steps = sorted(int(p.name) for p in ckpts.iterdir()
                       if p.name.isdigit())
        print(f"checkpoints: {steps if steps else 'none'}")
    exported = [p for p in ([run / "model"]
                            + sorted(run.glob("model_distilled*")))
                if p.exists()]
    for p in exported:
        print(f"exported params: {p}")
    if args.params:
        # Keep the model-shaping underscore keys (_encoder, _inject_depth,
        # _length, _num_splits, _text_encoder); strip the bookkeeping ones.
        drop = {"_task", "_sample_rate", "_upsample_factor", "_dtype",
                "_init_from"}
        net_cfg = {k: v for k, v in recorded.items() if k not in drop}
        if dtype:
            net_cfg["_dtype"] = dtype
        model = _build_model(net_cfg, "v", _device(args), task,
                             recorded.get("_upsample_factor"))
        n = sum(p.numel() for p in model.params.values())
        print(f"parameters: {n/1e6:.1f} M "
              f"({n*4/1e9:.2f} GB f32 master)")


def _cmd_serve(args) -> None:
    """Serve a trained model over HTTP: concurrent POSTs microbatch into
    fixed-size device batches (serve.py); results are quantized to PCM16 on
    the card and returned as WAV bodies."""
    from .serve import GenerationService
    from .server import make_server

    device = _device(args)
    if args.artifact is not None:
        # Deployment without the model's code: the exported step and the
        # parameter file are the whole payload (export.py). Shapes, steps
        # and batch are the artifact's; a mismatched request fails loudly.
        ignored = [flag for flag, given in [
            ("--steps", args.steps != 50), ("--sampler", args.sampler != "v"),
            ("--dtype", args.dtype != "bf16"),
            ("--length", args.length != 2**18),
            ("--batch-size", args.batch_size != 8),
            ("--preset", args.preset is not None)] if given]
        if ignored:
            print(f"warning: {', '.join(ignored)} ignored in --artifact "
                  "mode (steps, shapes and batch are the artifact's "
                  "manifest's; export again to change them)")
        from .export import ArtifactSampler, load_params

        model = ArtifactSampler(args.artifact,
                                load_params(args.model, device), device)
        service = GenerationService(
            model, num_steps=model.num_steps, batch_size=model.batch_size,
            max_wait_ms=args.max_wait_ms, result_format="pcm16")
        server = make_server(
            service,
            sample_rate=(args.sample_rate or model.sample_rate or 48000),
            default_length=model.length, channels=model.in_channels,
            task="unconditional", model=model, host=args.host,
            port=args.port, verbose=True)
        host, port = server.server_address[:2]
        print(f"serving artifact {args.artifact} ({model.num_steps}-step, "
              f"batch {model.batch_size}, length {model.length}) on "
              f"http://{host}:{port}", flush=True)
        _serve_until_stopped(server, service)
        return

    cfg, task, sample_rate, upsample_factor = _load_run_config(args)
    if task == "ar":
        raise SystemExit(
            "AR serving needs the Python API (its sampler generates from "
            "a generator, not per-request noise or input payloads)")
    model = _build_model(cfg, args.sampler, device, task, upsample_factor)
    c = cfg.get("in_channels", 2)
    model.load(args.model)
    service = GenerationService(
        model, num_steps=args.steps, batch_size=args.batch_size,
        max_wait_ms=args.max_wait_ms, result_format="pcm16",
        # Autoencoder serving batches latent -> audio decodes; /transform
        # encodes each upload before submitting it.
        method="decode" if task == "autoencoder" else "sample")
    server = make_server(
        service, sample_rate=sample_rate, default_length=args.length,
        channels=c, task=task, model=model, host=args.host, port=args.port,
        verbose=True)
    host, port = server.server_address[:2]
    print(f"serving {task} model ({args.steps}-step {args.sampler}, batch "
          f"{args.batch_size}, {sample_rate} Hz) on http://{host}:{port}",
          flush=True)
    print("POST /generate {\"seed\": 1}  |  GET /stats  |  GET /healthz"
          if task == "unconditional" else
          "POST /transform (WAV body)  |  GET /stats  |  GET /healthz",
          flush=True)
    _serve_until_stopped(server, service)


def _serve_until_stopped(server, service) -> None:
    # Orchestrators stop containers with SIGTERM: drain the batches in
    # flight instead of dying mid-request (KeyboardInterrupt covers ^C).
    import signal

    def _sigterm(_sig, _frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        service.close()


def _cmd_export(args) -> None:
    """Export a trained run's sampler (export.py): the artifact and the
    parameter file are the whole deployment payload; serving hosts run it
    without this package's model-definition code."""
    from .export import export_sampler

    device = _device(args)
    cfg, task, sample_rate, _ = _load_run_config(args)
    if task != "unconditional":
        raise SystemExit(
            f"export drives unconditional models; a {task} model's array "
            "conditioning needs the Python API (export_sampler(**cond))")
    cond = {}
    if args.embedding is not None:
        # Conditional artifact: the embedding is an INPUT of the program
        # (its shape from the example .npy, batched to the serving batch);
        # --embedding-scale bakes guided two-pass sampling in.
        import numpy as np
        import torch

        emb = np.load(args.embedding)
        cond["embedding"] = torch.zeros((args.batch_size,) + emb.shape,
                                        device=device)
        if args.embedding_scale is not None:
            cond["embedding_scale"] = args.embedding_scale
    elif args.embedding_scale is not None:
        raise SystemExit("--embedding-scale needs --embedding (the example "
                         ".npy that fixes the input shape)")
    model = _build_model(cfg, args.sampler, device, task)
    model.load(args.model)
    manifest = export_sampler(
        model, args.out, length=args.length, batch_size=args.batch_size,
        num_steps=args.steps, sample_rate=sample_rate, **cond)
    print(f"exported {manifest['noise_shape']} x {args.steps}-step "
          f"{args.sampler} sampler for {manifest['platforms']} to "
          f"{args.out}")


def _cmd_distill(args) -> None:
    """Progressive distillation (distill.py) of a trained run: halve the
    sampling step count stage by stage, so serving runs at --target-steps.
    The distilled parameters drop into the ordinary `sample`/`serve`
    commands::

        python -m audio_diffusion_torch distill --model run/model \\
            --data wavs/ --base-steps 64 --target-steps 8
        python -m audio_diffusion_torch sample \\
            --model run/model_distilled8 --steps 8 --out fast/
    """
    from .data import DeviceCorpus
    from .distill import ProgressiveDistiller

    device = _device(args)
    cfg, task, _, _ = _load_run_config(args)
    if task != "unconditional":
        raise SystemExit(
            f"distill drives unconditional models; a {task} model's "
            "conditioning channels need the Python API "
            "(ProgressiveDistiller.stage(**cond))")
    if args.guidance_scale is not None and not cfg.get("use_embedding_cfg"):
        raise SystemExit(
            "--guidance-scale requires a CFG model (use_embedding_cfg in "
            "the run config); this run has no guidance to distill")
    if args.guidance_scale is not None and args.embedding_dir is None:
        raise SystemExit(
            "--guidance-scale needs --embedding-dir: guidance distillation "
            "trains on (audio, embedding) pairs")
    # The halving ladder must land exactly on the target.
    stages, n = 0, args.base_steps
    while n > args.target_steps and n % 2 == 0:
        n //= 2
        stages += 1
    if n != args.target_steps or stages == 0:
        raise SystemExit(
            f"--target-steps {args.target_steps} is not reachable from "
            f"--base-steps {args.base_steps} by halving")
    mesh, device = _mesh(device)
    model = _build_model(cfg, "v", device, task)
    model.load(args.model)

    if args.embedding_dir is not None:
        # Paired embeddings ride each batch as (x, cond) tuples (host data
        # path, as in train --embedding-dir), so the teacher's conditional
        # predictions match how the model was trained.
        from .data import AudioDataset

        ds = AudioDataset(args.data, crop_frames=args.crop,
                          batch_size=args.batch, seed=args.seed,
                          return_indices=True)
        print(f"dataset: {len(ds.files)} files, {ds.channels} ch @ "
              f"{ds.sample_rate} Hz, crop {args.crop}, paired embeddings "
              f"from {args.embedding_dir}")
        batches = _rank_rows(
            _paired_feed(ds, _embedding_table(ds, args.embedding_dir)), mesh)
    else:
        ds = _load_dataset(args, device, mesh)
        batches = (iter(ds) if isinstance(ds, DeviceCorpus)
                   else _rank_rows(iter(ds), mesh))
    distiller = ProgressiveDistiller(model, base_steps=args.base_steps,
                                     learning_rate=args.lr, mesh=mesh)
    if args.guidance_scale is not None:
        distiller.guidance_stage(batches,
                                 embedding_scale=args.guidance_scale,
                                 num_train_steps=args.guidance_steps,
                                 log_every=args.log_every)
        print(f"guidance stage done: CFG scale {args.guidance_scale} "
              "distilled into a single conditional pass")
    for _ in range(stages):
        distiller.stage(batches, num_train_steps=args.stage_steps,
                        log_every=args.log_every)
        print(f"stage done: model now samples at {distiller.steps} steps")
    out = Path(args.out) if args.out else (
        Path(args.model).parent / f"model_distilled{args.target_steps}")
    if not _rank0(mesh):
        return
    out.parent.mkdir(parents=True, exist_ok=True)
    model.save(out)
    # `sample --model OUT` reads OUT's sibling config.json; an --out outside
    # the run has none, so the run's record is copied there.
    src_cfg = Path(args.model).parent / "config.json"
    dst_cfg = out.parent / "config.json"
    if src_cfg.exists() and not dst_cfg.exists():
        dst_cfg.write_text(src_cfg.read_text())
    print(f"saved distilled params to {out} — sample with "
          f"--model {out} --steps {args.target_steps}")


def _cmd_eval(args) -> None:
    """Score generated WAVs against a reference corpus: third-octave
    band-profile distances, their set-level Fréchet distance and the
    samples' diversity, each beside a white-noise baseline (eval.py). One
    JSON summary line last."""
    import numpy as np

    from .data import wav_probe, wav_read
    from .eval import (band_distance, band_profile, frechet_band_distance,
                       pairwise_diversity)

    refs = sorted(Path(args.ref).glob("*.wav"))[:args.max_ref]
    if not refs:
        raise SystemExit(f"no .wav files under {args.ref}")
    samples = sorted(Path(args.samples).glob("*.wav"))
    if not samples:
        raise SystemExit(f"no .wav files under {args.samples}")

    # One common crop so every profile lives on the same band grid.
    lengths = [wav_probe(f)[2] for f in refs + samples]
    crop = min([args.crop] + lengths) if args.crop else min(lengths)
    sr = args.sample_rate or wav_probe(refs[0])[1]

    ref_audio = np.stack([wav_read(f, 0, crop) for f in refs])
    ref_prof = band_profile(ref_audio, sr)
    rng = np.random.default_rng(0)
    noise_base = band_distance(band_profile(
        rng.standard_normal(ref_audio.shape[1:]).astype(np.float32)
        * float(ref_audio.std()), sr), ref_prof)

    dists = []
    sample_audio = []
    for f in samples:
        x = wav_read(f, 0, crop)
        sample_audio.append(x)
        d = band_distance(band_profile(x, sr), ref_prof)
        dists.append(d)
        print(f"{f.name}: band-dist {d:.3f}, rms {x.std():.3f}, "
              f"peak {np.abs(x).max():.3f}, "
              f"finite {bool(np.isfinite(x).all())}")
    div = (pairwise_diversity(np.stack(sample_audio), sr)
           if len(sample_audio) >= 2 else None)
    # The set-level Fréchet distance in band-profile space, against a set
    # of white-noise clips of the same size at the corpus rms.
    fbd = fbd_noise = None
    if len(sample_audio) >= 2 and len(refs) >= 2:
        fbd = frechet_band_distance(ref_audio, np.stack(sample_audio), sr)
        noise_set = (rng.standard_normal((len(sample_audio),)
                                         + ref_audio.shape[1:])
                     .astype(np.float32) * float(ref_audio.std()))
        fbd_noise = frechet_band_distance(ref_audio, noise_set, sr)

    def rounded(v):
        return round(v, 4) if v is not None else None

    summary = {"num_samples": len(samples), "sample_rate": sr,
               "crop": int(crop),
               "band_dist_mean": round(float(np.mean(dists)), 4),
               "band_dist_worst": round(float(np.max(dists)), 4),
               "noise_baseline": round(noise_base, 4),
               "frechet_band_dist": rounded(fbd),
               "frechet_noise_baseline": rounded(fbd_noise),
               "pairwise_diversity": rounded(div)}
    print(json.dumps(summary))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="audio_diffusion_torch",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_flag(p):
        p.add_argument("--device", default=None,
                       help="torch device (default: the CUDA card; pass "
                            "cpu to run the plain path on the CPU)")

    t = sub.add_parser("train", help="train on a directory of WAV files")
    t.add_argument("--data", required=True, help="directory of .wav files")
    t.add_argument("--preset", required=True,
                   help="presets name or JSON config path")
    t.add_argument("--out", required=True, help="run directory")
    t.add_argument("--steps", type=int, default=100_000)
    t.add_argument("--batch", type=int, default=8)
    t.add_argument("--crop", type=int, default=2**18)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--lr-schedule", choices=("constant", "cosine"),
                   default="constant",
                   help="cosine decays to 0 over --steps (with warmup)")
    t.add_argument("--warmup-steps", type=int, default=0)
    t.add_argument("--max-grad-norm", type=float, default=None,
                   help="global-norm gradient clipping")
    t.add_argument("--ema-decay", type=float, default=None)
    t.add_argument("--accum-steps", type=int, default=1)
    t.add_argument("--steps-per-call", type=int, default=1,
                   help="optimizer steps per train-step call (takes that "
                        "many stacked batches at once)")
    t.add_argument("--init-from", default=None, metavar="MODEL_FILE",
                   help="warm-start params from a saved model file "
                        "(optimizer and step counter start fresh — "
                        "existing checkpoints in --out still take "
                        "precedence)")
    t.add_argument("--checkpoint-every", type=int, default=1000)
    t.add_argument("--log-every", type=int, default=50)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--data-placement", choices=("auto", "host", "device"),
                   default="auto",
                   help="device: keep the corpus on the card and crop "
                        "batches there (no per-step uploads); auto picks "
                        "device for corpora <= 1 GiB")
    t.add_argument("--task", choices=("unconditional", "upsampler",
                                      "vocoder", "autoencoder", "ar"),
                   default=None,
                   help="model task (default: inferred from the preset "
                        "name or the JSON config's _task key)")
    t.add_argument("--upsample-factor", type=int, default=None,
                   help="upsampler task: the rate ratio (default 16)")
    t.add_argument("--num-splits", type=int, default=4,
                   help="ar task: σ-ladder splits of the --crop context "
                        "window")
    t.add_argument("--caption-dir", default=None, metavar="DIR",
                   help="sidecar captions: one DIR/<wav stem>.txt per "
                        "corpus file, encoded once through --text-encoder "
                        "and paired with that file's crops (needs a text-"
                        "conditional config, e.g. TEXT_CONDITIONAL_48K)")
    t.add_argument("--text-encoder", choices=("t5", "random", "stub"),
                   default="t5",
                   help="caption encoder: t5 = the pretrained t5-base (not "
                        "ported: its weights are not in the repository); "
                        "random = the T5 architecture with frozen random "
                        "weights; stub = hash embeddings (tests). Recorded "
                        "in config.json so `sample --text` reuses it")
    t.add_argument("--embedding-dir", default=None,
                   help="directory of per-file .npy embeddings "
                        "(<wav stem>.npy, [tokens, features]): trains a "
                        "cross-attention model on precomputed embeddings")
    t.add_argument("--embedding-mask-proba", type=float, default=0.1,
                   help="CFG embedding-dropout rate during --caption-dir "
                        "or --embedding-dir training")
    t.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                   help="compute dtype (master params stay f32)")
    device_flag(t)
    t.set_defaults(fn=_cmd_train)

    s = sub.add_parser("sample", help="generate WAVs from a trained model")
    s.add_argument("--model", required=True,
                   help="model file saved by `train` (…/model)")
    s.add_argument("--preset", default=None,
                   help="preset/JSON config; defaults to the config.json "
                        "recorded next to the model file by `train`")
    s.add_argument("--out", required=True)
    s.add_argument("--num", type=int, default=1)
    s.add_argument("--steps", type=int, default=50)
    s.add_argument("--sampler", choices=("v", "dpm"), default="v")
    s.add_argument("--length", type=int, default=2**18)
    s.add_argument("--in-channels", type=int, default=None)
    s.add_argument("--sample-rate", type=int, default=None,
                   help="defaults to the training data's rate "
                        "(from config.json), else 48000")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--input", default=None,
                   help="task-model input WAV: low-rate audio for an "
                        "upsampler, a reference WAV (mel source) for a "
                        "vocoder, audio to round-trip through the latent "
                        "for an autoencoder")
    s.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                   help="compute dtype; the recorded training config wins "
                        "when present")
    s.add_argument("--total-length", type=int, default=None,
                   help="generate audio LONGER than --length by chaining "
                        "RePaint-outpainted windows (generate_long); "
                        "--length stays the per-window size")
    s.add_argument("--overlap", type=int, default=None,
                   help="window overlap for --total-length "
                        "(default --length//4)")
    s.add_argument("--resamples", type=int, default=2,
                   help="RePaint harmonization resamples per step for "
                        "--total-length windows and --inpaint")
    s.add_argument("--text", default=None, metavar="CAPTION",
                   help="text prompt, encoded through the run's recorded "
                        "text encoder (train --caption-dir); combine with "
                        "--embedding-scale for classifier-free guidance")
    s.add_argument("--embedding", default=None,
                   help=".npy of precomputed conditioning embeddings "
                        "([tokens, features] broadcast to --num, or "
                        "[num, tokens, features])")
    s.add_argument("--embedding-scale", type=float, default=None,
                   help="CFG guidance scale (needs --embedding or --text "
                        "and a use_embedding_cfg model)")
    s.add_argument("--chunks", type=int, default=8,
                   help="ar task: number of generated chunks "
                        "(output length = chunks x length/num_splits)")
    s.add_argument("--inpaint", default=None,
                   help="WAV to inpaint: frames in "
                        "[--mask-start, --mask-end) are regenerated "
                        "(RePaint), the rest kept")
    s.add_argument("--mask-start", type=int, default=None,
                   help="first frame to regenerate (with --inpaint)")
    s.add_argument("--mask-end", type=int, default=None,
                   help="one past the last frame to regenerate")
    device_flag(s)
    s.set_defaults(fn=_cmd_sample)

    i = sub.add_parser("info", help="describe a training run (config, "
                       "geometry, checkpoints, optional param count)")
    i.add_argument("--run", required=True,
                   help="run directory written by `train`")
    i.add_argument("--params", action="store_true",
                   help="also build the model and count its parameters")
    device_flag(i)
    i.set_defaults(fn=_cmd_info)

    v = sub.add_parser(
        "serve", help="serve a trained model over HTTP (microbatching: "
        "concurrent requests share fixed-size device batches)")
    v.add_argument("--model", required=True,
                   help="model file saved by `train` (…/model)")
    v.add_argument("--preset", default=None,
                   help="preset/JSON config; defaults to the config.json "
                        "recorded next to the model file")
    v.add_argument("--artifact", default=None,
                   help="serve from an artifact written by `export` (no "
                        "model-definition code: --model is just the "
                        "parameter file; shapes, steps and batch come from "
                        "the artifact's manifest)")
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=8000)
    v.add_argument("--batch-size", type=int, default=8,
                   help="device batch size (partial batches are padded)")
    v.add_argument("--steps", type=int, default=50,
                   help="default sampling steps (per-request num_steps "
                        "overrides)")
    v.add_argument("--max-wait-ms", type=float, default=100.0,
                   help="how long to hold an incomplete batch open")
    v.add_argument("--length", type=int, default=2**18,
                   help="default generation length in frames")
    v.add_argument("--sampler", choices=("v", "dpm"), default="v")
    v.add_argument("--sample-rate", type=int, default=None)
    v.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    device_flag(v)
    v.set_defaults(fn=_cmd_serve)

    x = sub.add_parser(
        "export", help="export the sampler (one traced step + manifest): "
        "deploy without the model-definition code")
    x.add_argument("--model", required=True,
                   help="model file saved by `train` (…/model)")
    x.add_argument("--out", required=True, help="artifact directory")
    x.add_argument("--preset", default=None,
                   help="preset/JSON config; defaults to the config.json "
                        "recorded next to the model file")
    x.add_argument("--length", type=int, default=2**18)
    x.add_argument("--batch-size", type=int, default=1)
    x.add_argument("--steps", type=int, default=50)
    x.add_argument("--sampler", choices=("v", "dpm"), default="v")
    x.add_argument("--sample-rate", type=int, default=None)
    x.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    x.add_argument("--embedding", default=None,
                   help="example .npy fixing the conditional artifact's "
                        "embedding input shape (batched to --batch-size)")
    x.add_argument("--embedding-scale", type=float, default=None,
                   help="bake guided two-pass CFG at this scale into the "
                        "artifact")
    device_flag(x)
    x.set_defaults(fn=_cmd_export)

    d = sub.add_parser(
        "distill", help="progressively distill a trained model to fewer "
        "sampling steps (64 -> 8)")
    d.add_argument("--model", required=True,
                   help="model file saved by `train` (…/model)")
    d.add_argument("--data", required=True,
                   help="directory of .wav files (the training corpus)")
    d.add_argument("--preset", default=None,
                   help="preset/JSON config; defaults to the config.json "
                        "recorded next to the model file")
    d.add_argument("--base-steps", type=int, default=64,
                   help="step count the teacher is considered to run at")
    d.add_argument("--target-steps", type=int, default=8,
                   help="distilled step count (base halved stage by stage)")
    d.add_argument("--stage-steps", type=int, default=2000,
                   help="training steps per halving stage")
    d.add_argument("--lr", type=float, default=2e-5)
    d.add_argument("--batch", type=int, default=4)
    d.add_argument("--crop", type=int, default=2**18)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--log-every", type=int, default=200)
    d.add_argument("--data-placement", choices=("auto", "host", "device"),
                   default="auto")
    d.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    d.add_argument("--embedding-dir", default=None,
                   help="paired per-file .npy embeddings (text-conditional "
                        "runs trained with train --embedding-dir)")
    d.add_argument("--guidance-scale", type=float, default=None,
                   help="distill classifier-free guidance at this scale "
                        "into a single conditional pass first (Meng et "
                        "al. 2023); requires --embedding-dir")
    d.add_argument("--guidance-steps", type=int, default=2000,
                   help="training steps for the guidance stage")
    d.add_argument("--out", default=None,
                   help="output params file (default: "
                        "<run>/model_distilled<target>)")
    device_flag(d)
    d.set_defaults(fn=_cmd_distill)

    e = sub.add_parser(
        "eval", help="score generated WAVs against a reference corpus "
        "(third-octave band-profile distance, Fréchet distance, "
        "diversity)")
    e.add_argument("--ref", required=True,
                   help="directory of reference corpus WAVs")
    e.add_argument("--samples", required=True,
                   help="directory of generated WAVs to score")
    e.add_argument("--crop", type=int, default=None,
                   help="analysis length in frames (default: shortest "
                        "file among refs+samples)")
    e.add_argument("--max-ref", type=int, default=16,
                   help="number of reference files for the corpus profile")
    e.add_argument("--sample-rate", type=int, default=None,
                   help="override the rate probed from the first ref")
    e.set_defaults(fn=_cmd_eval)

    args = ap.parse_args(argv)
    args.fn(args)
