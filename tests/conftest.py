import jax
import pytest

# NOTE: no XLA_FLAGS here — smoke tests must see the real (1-device) CPU.
# The multi-pod dry-run sets its own flags as a separate process.


def make_batch(cfg, rng, B=2, S=16, with_labels=True):
    """Batch dict matching the model contract for any arch family."""
    r1, r2 = jax.random.split(rng)
    batch = {"tokens": jax.random.randint(r1, (B, S), 0, cfg.vocab_size)}
    if with_labels:
        batch["labels"] = jax.random.randint(r2, (B, S), 0, cfg.vocab_size)
    if cfg.arch_type == "vlm":
        batch["patch_embeds"] = 0.1 * jax.random.normal(
            r1, (B, cfg.n_patches, cfg.d_model)
        )
    if cfg.arch_type == "audio":
        batch["audio_frames"] = 0.1 * jax.random.normal(
            r1, (B, cfg.n_audio_frames, cfg.d_model)
        )
    return batch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips at run time where torch sees none"
    )


@pytest.fixture
def rng():
    return jax.random.PRNGKey(0)
