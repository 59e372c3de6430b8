"""Train a (latent/conditional) diffusion UNet with the port, on one device or one process per card:

    python -m audio_diffusion_torch.training --dataset DIR --output_dir OUT [--vae VAE_DIR] [--device cpu]
    torchrun --nproc_per_node N -m audio_diffusion_torch.training --dataset DIR ... [--param_sharding fsdp]

The flags of the JAX package's ``scripts/train_unet.py`` plus ``--device``
(default ``cuda``; without a card it raises unless ``--device cpu`` is
given). Under ``torchrun`` each process joins the group (NCCL on the cards,
gloo with ``--device cpu``) and trains on ``cuda:$LOCAL_RANK`` with its rows
of every microbatch; ``--train_batch_size`` is the global microbatch and
``--mesh_data``, when given, must equal the number of processes. Rank 0
alone logs, saves and prints the result. ``--push_to_hub true`` raises: the
port has no network path.
"""

import argparse
import logging
import sys

import torch.distributed as dist

from ..parallel.mesh import init_distributed
from .loop import RunConfig, run_training
from .train_unet import TrainConfig


def _str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes", "y"):
        return True
    if v.lower() in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"boolean expected, got {v!r}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m audio_diffusion_torch.training", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", "--dataset_name", dest="dataset", type=str, required=True,
                   help="HF dataset dir or folder of PNG spectrogram slices")
    p.add_argument("--output_dir", type=str, default="ddpm-model-64")
    p.add_argument("--train_batch_size", type=int, default=16)
    p.add_argument("--eval_batch_size", type=int, default=16)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--save_images_epochs", type=int, default=10)
    p.add_argument("--save_model_epochs", type=int, default=10)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--lr_scheduler", type=str, default="cosine", choices=["cosine", "linear", "constant"])
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--adam_beta1", type=float, default=0.95)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-6)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--use_ema", type=_str2bool, default=True)
    p.add_argument("--ema_inv_gamma", type=float, default=1.0)
    p.add_argument("--ema_power", type=float, default=0.75)
    p.add_argument("--ema_max_decay", type=float, default=0.9999)
    p.add_argument("--hop_length", type=int, default=512)
    p.add_argument("--sample_rate", type=int, default=22050)
    p.add_argument("--n_fft", type=int, default=2048)
    p.add_argument("--from_pretrained", type=str, default=None, help="diffusers-layout pipeline directory")
    p.add_argument("--num_train_steps", type=int, default=1000)
    p.add_argument("--scheduler", type=str, default="ddpm", choices=["ddpm", "ddim"])
    p.add_argument("--prediction_type", type=str, default="epsilon", choices=["epsilon", "v_prediction"])
    p.add_argument("--vae", type=str, default=None, help="diffusers-layout VAE dir for latent diffusion")
    p.add_argument("--cache_latents", type=_str2bool, default=True,
                   help="latent training: encode the dataset once and sample posteriors from the cached moments")
    p.add_argument("--encodings", type=str, default=None,
                   help="pickled {audio_file: encoding} for conditional training")
    p.add_argument("--mixed_precision", type=str, default="no", choices=["no", "bf16"])
    p.add_argument("--param_sharding", type=str, default="replicated", choices=["replicated", "fsdp"])
    p.add_argument("--mesh_data", type=int, default=None,
                   help="the data axis: must equal the number of processes (torchrun --nproc_per_node)")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--push_to_hub", type=_str2bool, default=False)
    p.add_argument("--hub_model_id", type=str, default=None)
    p.add_argument("--hub_token", type=str, default=None)
    p.add_argument("--hub_private_repo", type=_str2bool, default=False)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    a = parse_args(argv)
    if a.push_to_hub:
        raise SystemExit("--push_to_hub: the port has no network path; copy --output_dir to a connected machine")
    run = RunConfig(
        dataset=a.dataset, output_dir=a.output_dir, num_epochs=a.num_epochs,
        train_batch_size=a.train_batch_size, eval_batch_size=a.eval_batch_size,
        save_images_epochs=a.save_images_epochs, save_model_epochs=a.save_model_epochs,
        scheduler=a.scheduler, num_train_steps=a.num_train_steps,
        hop_length=a.hop_length, sample_rate=a.sample_rate, n_fft=a.n_fft,
        from_pretrained=a.from_pretrained, vae=a.vae, encodings=a.encodings, cache_latents=a.cache_latents,
        mixed_precision=a.mixed_precision, mesh_data=a.mesh_data, seed=a.seed, max_steps=a.max_steps,
        device=a.device,
    )
    train = TrainConfig(
        learning_rate=a.learning_rate, lr_schedule=a.lr_scheduler, lr_warmup_steps=a.lr_warmup_steps,
        adam_beta1=a.adam_beta1, adam_beta2=a.adam_beta2,
        adam_weight_decay=a.adam_weight_decay, adam_epsilon=a.adam_epsilon,
        gradient_accumulation_steps=a.gradient_accumulation_steps,
        use_ema=a.use_ema, ema_inv_gamma=a.ema_inv_gamma, ema_power=a.ema_power, ema_max_decay=a.ema_max_decay,
        prediction_type=a.prediction_type, param_sharding=a.param_sharding,
    )
    rank = init_distributed(device=a.device)  # the torchrun environment, else one process
    try:
        result = run_training(run, train)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank == 0:
        print(result)
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
