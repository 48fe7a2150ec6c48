"""PBnet CVAE: the training forward and loss, the generation API and the
architecture factory.

Port of ``dawn_tpu/models/pbnet/cvae.py:60-307``: ``forward`` (encode,
reparameterise, decode; cvae.py:20-38 of the reference) and
``compute_loss`` (the weighted losses with the KL annealing of
cae.py:66-85), ``encode``, ``decode`` and ``generate`` (per-frame z ~
N(0, 1), decoded into pose or blink drives from audio; cae.py:112-166) and
the modelname / opt.yaml driven factory. ``CVAE`` is an ``nn.Module`` whose
state_dict is the reference checkpoint's (``encoder.*``, ``decoder.*``).

The module puts itself in eval mode when it is built. Only ``forward``
reads the mode: in training mode it applies dropout (drawn from the
caller's generator) and leaves the decoder's eval window out, as the JAX
package's non-deterministic CVAE does. ``encode``, ``decode`` and
``generate`` run without dropout and with the window whatever the mode.

Only the deployed reemb family is ported (the rows of ``_ARCH_TABLE``); the
other registered architectures raise (ROADMAP queue 1 item 15).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from dawn_tpu_torch import resolve_device
from dawn_tpu_torch.models.pbnet import losses as L
from dawn_tpu_torch.models.pbnet.architectures import (DecoderTransformerReemb6,
                                                       EncoderTransformerReemb6)
from dawn_tpu_torch.models.pbnet.layers import Dropout

# the reference registry (get_model.py:16) plus 'mlp', as the JAX package has it
ARCHINAMES = ("fc", "gru", "mlp", "transformer", "transformerreemb5",
              "transformerreemb6", "transformerreemb7", "transformerreemb8",
              "transformermel", "transgru", "grutrans", "autotrans")
MODELTYPES = ("cae", "cvae")

# archiname -> eval window of the decoder's position bias. reemb5 is the
# joint pose+eye model (window 200), reemb6 the separate pose / blink models
# (100); reemb7/8 and transformermel have no module upstream and build as
# reemb6 (transformermel without the window), as in the JAX package.
_ARCH_TABLE = {
    "transformerreemb5": 200,
    "transformerreemb6": 100,
    "transformerreemb7": 100,
    "transformerreemb8": 100,
    "transformermel": None,
}


def parse_modelname(modelname: str):
    """'{modeltype}_{archiname}_{loss1}_{loss2}...' -> parts
    (parser/model.py:30-44)."""
    modeltype, archiname, *losses = modelname.split("_")
    if modeltype not in MODELTYPES:
        raise NotImplementedError(f"model type {modeltype!r}")
    if archiname not in ARCHINAMES:
        raise NotImplementedError(f"architecture {archiname!r}")
    if not losses:
        raise NotImplementedError("at least one loss is required")
    return modeltype, archiname, losses


def kl_anneal(epoch: float) -> float:
    """The KL weight of cae.py:72-76, oddities included: 1 at epoch 0, 0 for
    epochs 1 to 9,999, then max(epoch - 1e4, 7e4) / 7e4 (1 up to epoch
    80,000, growing past it)."""
    if epoch == 0:
        return 1.0
    return 0.0 if epoch < 1e4 else max(epoch - 1e4, 7e4) / 7e4


@dataclasses.dataclass
class PBnetParams:
    """The hyperparameters of a PBnet opt.yaml dict (the mlp arch's fixed
    length is not ported)."""
    pos_dim: int = 6
    eye_dim: int = 0
    audio_dim: int = 1024
    latent_dim: int = 256          # == audio_latent_dim in the archi
    pose_latent_dim: int = 64
    ff_size: int = 128
    num_layers: int = 2
    num_heads: int = 4
    num_buckets: int = 128
    max_distance: int = 128
    dropout: float = 0.1
    archiname: str = "transformerreemb6"
    lambdas: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {"rc": 1.0, "kl": 1.0, "reg": 0.1})

    @classmethod
    def from_opt(cls, opt: Mapping[str, Any]) -> "PBnetParams":
        """Build from a loaded opt.yaml. The reemb family reads
        audio_latent_dim (transformerreemb6.py:148,159), so it wins over the
        parser's unused latent_dim."""
        def g(key, default):
            return opt.get(key, default)
        return cls(
            pos_dim=int(g("pos_dim", 6)),
            eye_dim=int(g("eye_dim", 0)),
            audio_dim=int(g("audio_dim", 1024)),
            latent_dim=int(g("audio_latent_dim", g("latent_dim", 256))),
            ff_size=int(g("ff_size", 128)),
            num_layers=int(g("num_layers", 2)),
            num_heads=int(g("num_heads", 4)),
            num_buckets=int(g("num_buckets", 128)),
            max_distance=int(g("max_distance", 128)),
            dropout=float(g("dropout", 0.1)),
            archiname=g("archiname", "transformerreemb6"),
            lambdas=dict(g("lambdas", {"rc": 1.0, "kl": 1.0, "reg": 0.1})),
        )

    @property
    def feature_dim(self) -> int:
        """The pose-or-blink width the model generates (the reference carries
        eye ratios through the pos slots)."""
        return self.pos_dim + self.eye_dim


class CVAE(nn.Module):
    """The reemb-family CVAE, on the card unless ``device="cpu"``.
    Parameters are torch's default init until weights are loaded."""

    def __init__(self, params: PBnetParams, device=None):
        super().__init__()
        if params.archiname not in ARCHINAMES:
            raise NotImplementedError(
                f"archiname {params.archiname!r} is not in the reference registry {ARCHINAMES}")
        if params.archiname not in _ARCH_TABLE:
            raise NotImplementedError(
                f"PBnet architecture {params.archiname!r} is not ported yet (ROADMAP queue 1 "
                f"item 15); the port has the reemb family {tuple(_ARCH_TABLE)}")
        self.hp = params
        self.device = resolve_device(device)
        kw = dict(pos_dim=params.feature_dim, audio_dim=params.audio_dim,
                  pose_latent_dim=params.pose_latent_dim, audio_latent_dim=params.latent_dim,
                  ff_size=params.ff_size, num_layers=params.num_layers,
                  num_heads=params.num_heads)
        self.encoder = EncoderTransformerReemb6(**kw)
        self.decoder = DecoderTransformerReemb6(
            **kw, num_buckets=params.num_buckets, max_distance=params.max_distance,
            eval_window=_ARCH_TABLE[params.archiname])
        self.to(self.device)
        self.eval()

    def _to(self, *xs):
        return [None if x is None else x.to(self.device) for x in xs]

    def forward(self, x: torch.Tensor, y: torch.Tensor, mask: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                shard: Optional[Tuple[int, slice]] = None) -> Dict[str, torch.Tensor]:
        """The training forward (cvae.py:20-38): encode, z = mu + exp(logvar /
        2) * eps, decode. x (B, T, D) absolute pose or blink; y (B, T, 1024);
        mask (B, T), True where valid. ``eps`` (B, T, latent) is drawn from
        ``generator`` unless given, and so is the dropout of training mode.
        ``shard`` = (n, rows): x holds the rows ``rows`` of a batch of n, and
        eps and the dropout masks are drawn for the whole batch and sliced
        (a data-parallel step). Returns 'output' (padded frames zeroed), 'z',
        'mu', 'logvar', 'x_delta'."""
        x, y, mask = self._to(x.float(), y.float(), mask)
        train = self.training
        drop = (Dropout(self.hp.dropout, generator, shard)
                if train and self.hp.dropout > 0 else None)
        enc = self.encoder(x, y, mask, drop)
        if eps is None:
            n, rows = shard or (x.shape[0], slice(None))
            eps = torch.randn((n, *enc["mu"].shape[1:]), generator=generator,
                              device=self.device)[rows]
        z = enc["mu"] + torch.exp(0.5 * enc["logvar"]) * eps.to(self.device)
        out = self.decoder(x, z, y, mask, drop, eval_mask=not train)
        return {"output": out, "z": z, **enc}

    def compute_loss(self, batch_out: Dict[str, torch.Tensor], x_delta: torch.Tensor,
                     mask: Optional[torch.Tensor], epoch: float = 0,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict[str, torch.Tensor]] = None, encode_fn=None,
                     total=L.no_reduce, shard: Optional[Tuple[int, slice]] = None):
        """The mixed loss sum_k lambda_k loss_k over ``hp.lambdas`` and the
        terms (cae.py:66-85), every loss of the reference's registry, the KL
        annealed by :func:`kl_anneal`. 'mmd' takes its N(0, 1) samples (the
        whole batch's) and 'hp' its directions (this batch's rows) from
        ``draws`` ('mmd', 'hp'), else from ``generator``; 'hp' needs
        ``encode_fn`` (x -> latent, the reference's model.return_latent).
        ``total`` holds the reductions over the ranks of a data-parallel
        step and ``shard`` = (n, rows) this rank's rows of the batch of n
        (see :mod:`.losses`): every term is then this rank's share."""
        hp = self.hp
        draws = draws or {}
        out = batch_out["output"]
        m = (torch.ones(out.shape[:2], dtype=out.dtype, device=out.device) if mask is None
             else mask.to(out.dtype))
        losses = {}
        for name in hp.lambdas:
            if name == "kl":
                losses["kl"] = kl_anneal(epoch) * L.kl_loss(batch_out["mu"],
                                                            batch_out["logvar"], m, total)
            elif name == "mmd":
                losses["mmd"] = L.mmd_loss(batch_out["z"], draws.get("mmd"), generator,
                                           total=total)
            elif name == "hp":
                losses["hp"] = L.hessian_penalty(encode_fn, x_delta, dzs=draws.get("hp"),
                                                 generator=generator, total=total, shard=shard)
            else:
                losses[name] = L.get_loss_function(name)(out, x_delta, m, total=total)
        mixed = sum(hp.lambdas[k] * v for k, v in losses.items())
        losses["mixed"] = mixed
        return mixed, losses

    @torch.no_grad()
    def encode(self, x, y, mask=None) -> Dict[str, torch.Tensor]:
        x, y, mask = self._to(x.float(), y.float(), mask)
        return self.encoder(x, y, mask)

    @torch.no_grad()
    def decode(self, x, z, y, mask=None) -> torch.Tensor:
        x, z, y, mask = self._to(x.float(), z.float(), y.float(), mask)
        return self.decoder(x, z, y, mask)

    @torch.no_grad()
    def generate(self, init_state: torch.Tensor, audio: torch.Tensor, fact: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Inference (cae.py:112-166): per-frame z = fact * N(0, 1), drawn
        from ``generator`` (on its device) unless ``z`` is given, decoded
        into drives.

        init_state: (B, D) normalized first-frame pose (or blink); audio:
        (B, T, 1024). Returns the drive changes (B, T, D); the caller adds
        the init state and de-normalizes."""
        b, t, _ = audio.shape
        if z is None:
            dev = generator.device if generator is not None else self.device
            z = fact * torch.randn(b, t, self.hp.latent_dim, generator=generator, device=dev)
        x = init_state[:, None].expand(b, t, init_state.shape[-1])
        return self.decode(x, z, audio)


def build_pbnet(opt: Mapping[str, Any], device=None) -> CVAE:
    """Factory mirroring get_model.py: opt.yaml dict -> CVAE."""
    return CVAE(PBnetParams.from_opt(opt), device=device)


def get_model(parameters: Mapping[str, Any], device=None) -> CVAE:
    """Reference get_model (get_model.py:19-35): a parameters dict carrying
    ``modelname`` (e.g. 'cvae_transformerreemb6_rc_kl_reg') plus
    hyperparameters."""
    parameters = dict(parameters)
    if "modelname" in parameters:
        modeltype, archiname, _ = parse_modelname(parameters["modelname"])
        if modeltype != "cvae":
            raise NotImplementedError("only the cvae modeltype is deployed")
        parameters["archiname"] = archiname
    return build_pbnet(parameters, device=device)
