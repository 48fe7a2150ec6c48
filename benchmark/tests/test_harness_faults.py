"""A run with the timed path broken underneath comes out not correct, and
so does the control; a sound run comes out correct. All on the CPU at the
tiny cell's size: the look for a card is skipped and the rest of a run is
driven (set-up, window, the kept call against the reference)."""

import pytest
import torch

from benchmark import calibrate, run
from dawn_tpu_torch.models.dm import diffusion, flow_diffusion
from dawn_tpu_torch.models.lfg import generator


def _run(cell, seed=2 ** 31 + 21):
    result, _, err = run.run_cell(cell, seed, 0.05, False, "cpu")
    return result, err


def test_a_sound_run_is_correct(tiny_cell):
    result, err = _run(tiny_cell)
    assert result["correct"], err
    assert set(result["checks"]) == {"latent_err", "decode_err", "video_err", "failed_clips"}
    assert list(result)[-1] == "checks"
    assert err[-1].startswith("failed_clips") and " limit " in err[-1]


def test_a_step_that_returns_its_state_unchanged(tiny_cell, monkeypatch):
    """The last DDIM step hands its input on: the latent is the state
    before it."""
    def broken(self, denoise_fn, shape, cond, cond_scale=1.0, noise_seq=None,
               generator=None, device=None, view=(), group=None):
        normal = self._normal(noise_seq, shape, generator, device, view)
        acp = self.bufs["alphas_cumprod_prev"]
        img = normal(0)
        times = diffusion.ddim_times(self.timesteps, self.sampling_timesteps)
        for i, (time, time_next) in enumerate(times):
            if i == len(times) - 1:
                break                                   # the fault
            alpha, alpha_next = acp[time], acp[time_next]
            tvec = torch.full((img.shape[0],), time, dtype=torch.int64, device=device)
            eps = self._cfg_eps(denoise_fn, img, tvec, cond, cond_scale)
            x0 = self._threshold(self.predict_start_from_noise(img, tvec, eps), group)
            sigma = self.ddim_sampling_eta * torch.sqrt(
                (1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
            c = torch.sqrt(torch.clamp((1 - alpha_next) - sigma ** 2, min=0.0))
            img = (x0 * torch.sqrt(alpha_next).item() + c.item() * eps
                   + float(time_next > 0) * sigma.item() * normal(i + 1))
        return img
    monkeypatch.setattr(diffusion.GaussianDiffusion, "ddim_sample", broken)
    result, err = _run(tiny_cell)
    assert not result["correct"], err


def test_half_of_the_batch_left_out(tiny_cell, monkeypatch):
    """Only the first half of the clips is sampled; the rest repeat it."""
    sample = flow_diffusion.FlowDiffusion.sample_one_video

    def broken(self, sample_img, audio_hubert, pose, eye, bbox, *args, noise_seq=None,
               **kwargs):
        h = sample_img.shape[0] // 2
        out = sample(self, sample_img[:h], audio_hubert[:h], pose[:h], eye[:h], bbox[:h],
                     *args, noise_seq=noise_seq[:, :h], **kwargs)
        return {k: torch.cat([v, v], dim=0) for k, v in out.items()}
    monkeypatch.setattr(flow_diffusion.FlowDiffusion, "sample_one_video", broken)
    result, err = _run(tiny_cell)
    assert not result["correct"], err


def test_a_frame_altered_where_it_is_produced(tiny_cell, monkeypatch):
    """One decoded frame of one clip comes out brighter."""
    decode = generator.LFGGenerator.decode_shared

    def broken(self, *args, **kwargs):
        out = decode(self, *args, **kwargs)
        pred = out["prediction"].clone()
        pred[0, -1] = (pred[0, -1] + 0.1).clamp(0, 1)
        return dict(out, prediction=pred)
    monkeypatch.setattr(generator.LFGGenerator, "decode_shared", broken)
    result, err = _run(tiny_cell)
    assert not result["correct"], err
    assert result["checks"]["video_err"]["value"] > result["checks"]["video_err"]["limit"]


def test_the_control_fails_and_the_program_passes(tiny_cell):
    """The reference one precision below the configuration's (fp8 operands
    in the UNet, bf16 in the decoder) in the program's place fails a limit
    on every seed; the program meets both."""
    seeds = [3, 2 ** 31 + 4]
    r = calibrate.readings(tiny_cell, seeds, len(seeds), "cpu", log=lambda s: None)
    for name, values in r["program"].items():
        assert max(values) <= tiny_cell.limits[name]["limit"], (name, values)
    for i in range(len(seeds)):
        assert any(r["control"][n][i] > tiny_cell.limits[n]["limit"] for n in r["control"]), i


@pytest.mark.parametrize("kind", ["fp8", "bf16"])
def test_operand_rounding(kind):
    from benchmark.reference.dawn import Operands
    x = torch.linspace(-3, 3, 101)
    y = Operands(kind)(x)
    rel = ((y - x).abs() / x.abs().clamp_min(1e-3)).max().item()
    assert 0 < rel <= (2 ** -3 if kind == "fp8" else 2 ** -8)
