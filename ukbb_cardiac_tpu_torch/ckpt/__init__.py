"""Model bundles: reading and writing the framework-neutral npz format,
and carrying its weights into the port's modules."""

from ukbb_cardiac_tpu_torch.ckpt.store import load_model, save_model
