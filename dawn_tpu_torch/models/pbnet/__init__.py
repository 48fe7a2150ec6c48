"""PBnet pose/blink CVAE, the deployed reemb family (pipeline stage 3)."""

from dawn_tpu_torch.models.pbnet.cvae import (  # noqa: F401
    ARCHINAMES, CVAE, MODELTYPES, PBnetParams, build_pbnet, get_model, parse_modelname,
)
from dawn_tpu_torch.models.pbnet.architectures import (  # noqa: F401
    DecoderTransformerReemb6, EncoderTransformerReemb6,
)
