"""HuBERT speech encoder (pipeline stage 2)."""

from dawn_tpu_torch.models.hubert.model import HubertConfig, HubertModel  # noqa: F401
