"""Export a checkpoint to the reference's TF object-checkpoint format.

    python -m ddsp_piano_torch.export_tf_checkpoint
        [-c maestro_v2|dafx22|dafx22_24khz] --ckpt PATH --out PREFIX

Counterpart of the JAX package's export_tf_checkpoint.py. ``--ckpt`` is the
port's own checkpoint (``ckpt.pt``, or a directory holding one, as the
train CLI writes them) or a TF checkpoint, re-exported unchanged. The
variables are written under the Keras object paths that the reference's
TF object-based restore resolves (``model/<slot>/.../.ATTRIBUTES/
VARIABLE_VALUE``). The export is host work: it runs on the CPU, has no
--device flag, and needs TensorFlow.
"""

from __future__ import annotations

import argparse
import logging

log = logging.getLogger(__name__)


def process_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--config', '-c', type=str, default='maestro_v2',
                        help="Model config name. (default: %(default)s)")
    parser.add_argument('--ckpt', type=str, required=True,
                        help="Checkpoint to export (the port's ckpt.pt, file "
                             "or directory, or a TF checkpoint).")
    parser.add_argument('--out', type=str, required=True,
                        help="Output TF checkpoint prefix (e.g. "
                             ".../ckpt-0).")
    return parser.parse_args(argv)


def main(args) -> str:
    """Write the TF checkpoint; returns its prefix."""
    from ddsp_piano_torch.configs import get_model
    from ddsp_piano_torch.training import checkpoints

    model = get_model(args.config, device='cpu')
    checkpoints.restore_params(model, args.ckpt)
    written = checkpoints.export_tf_weights(model, args.out)
    log.info("Wrote %d variables to TF checkpoint %s",
             len(checkpoints.tf_name_map(model)), written)
    return written


if __name__ == '__main__':
    logging.basicConfig(level=logging.INFO, format='%(message)s')
    main(process_args())
