"""The port's command line: ``python -m mamdr_tpu_torch.run``.

Counterpart of ``mamdr_tpu/run.py`` (:20-89), after the reference's run.py
(:25-99): load a config, load the multi-domain dataset (the built-in
synthetic one, or the reference's on-disk layout), build the model and the
strategy from the model name, run it (train, test, the finetune stage where
the name asks for it) and write the result folder
(``<result_save_path>/<model>/<dataset>/<split>/loss_X_auc_Y_<time>/``)::

    python -m mamdr_tpu_torch.run --config experiment.json
    python -m mamdr_tpu_torch.run --benchmark Taobao_30/mlp_meta_mamdr_finetune
    python -m mamdr_tpu_torch.run --list-benchmarks
    python -m mamdr_tpu_torch.run --config experiment.json --device cpu
    python -m mamdr_tpu_torch.run --config experiment.json --resume

It runs on the CUDA card, and raises without one, unless ``--device cpu``
asks for the CPU (the kernels' plain versions). ``--resume`` continues a
run from its snapshot under ``<checkpoint_path>/<model>/<dataset>/<split>/resume``
where there is one, and writes it every epoch (``train.resume_every``, 1
when the config leaves it 0).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from mamdr_tpu_torch import DeviceLike
from mamdr_tpu_torch.config import ExperimentConfig, load_config
from mamdr_tpu_torch.data.dataset import MultiDomainDataset
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset
from mamdr_tpu_torch.strategies.base import build_strategy
from mamdr_tpu_torch.train.trainer import Trainer


def main(config: ExperimentConfig, verbose: bool = True, device: DeviceLike = None):
    """Run one experiment and write its result folder. Returns (avg_loss,
    avg_auc, domain_loss, domain_auc) of the final test."""
    dc = config.dataset
    if dc.name == "synthetic":
        dataset = make_synthetic_dataset(
            n_domain=dc.n_domain, n_uid=dc.n_uid, n_pid=dc.n_pid,
            n_per_domain=dc.n_per_domain, seed=dc.seed, batch_size=dc.batch_size)
    else:
        dataset = MultiDomainDataset.from_disk(dc)
    trainer = Trainer(config, dataset, device=device, verbose=verbose)
    strategy = build_strategy(trainer)
    result = strategy.run()
    trainer.save_result(*result)
    return result


def cli(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(prog="python -m mamdr_tpu_torch.run")
    parser.add_argument("--config", type=str, help="Train config JSON file")
    parser.add_argument(
        "--benchmark", type=str,
        help="Named benchmark config, e.g. Taobao_30/mlp_meta_mamdr_finetune "
        "(see --list-benchmarks)")
    parser.add_argument("--list-benchmarks", action="store_true",
                        help="List benchmark configs")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the config's restart-safe snapshot (train.resume); "
                        "a snapshot is written every epoch unless train.resume_every says "
                        "otherwise")
    parser.add_argument("--device", type=str, default=None,
                        help="Run on this device; the default is the CUDA card, and 'cpu' "
                        "runs the kernels' plain versions on the CPU")
    args = parser.parse_args(argv)
    if args.list_benchmarks:
        from mamdr_tpu_torch.benchmarks import list_configs

        print("\n".join(list_configs()))
        return None
    if args.benchmark:
        from mamdr_tpu_torch.benchmarks import benchmark_config

        bench, _, model_name = args.benchmark.partition("/")
        cfg = benchmark_config(bench, model_name)
    elif args.config:
        cfg = load_config(args.config)
    else:
        parser.error("one of --config / --benchmark / --list-benchmarks required")
    if args.resume:
        cfg.train.resume = True
        cfg.train.resume_every = cfg.train.resume_every or 1
    return main(cfg, device=args.device)


if __name__ == "__main__":
    cli()
