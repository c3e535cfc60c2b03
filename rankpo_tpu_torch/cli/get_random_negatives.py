"""Random-negative bootstrap entry point (port of
``rankpo_tpu.cli.get_random_negatives``; reference
src/get_random_negatives.py).

    python -m rankpo_tpu_torch.cli.get_random_negatives \\
        --input_file mining.jsonl --output_file train_iter0.jsonl \\
        --num_negatives 15 --seed 0 --device cuda

The sampling runs on the host; ``--device`` is resolved like every entry
point of the port's (``cuda``, the default, fails when no card is visible),
so a pipeline that starts here fails at once on a host without its card.
"""

from __future__ import annotations

import argparse

from rankpo_tpu_torch.core.device import resolve_device
from rankpo_tpu_torch.tools.random_negatives import find_random_negatives


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_file", type=str, required=True)
    parser.add_argument("--output_file", type=str, required=True)
    parser.add_argument("--num_negatives", type=int, default=15)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' fails when no card is visible")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    return find_random_negatives(
        args.input_file, args.output_file, args.num_negatives, seed=args.seed
    )


if __name__ == "__main__":
    main()
