"""Second references for the port beside the JAX package: the vit_pytorch
generations of the ViT, the cv2 / PIL golden cases of the resize and the
GenCAD edge image (after ``tests/test_resize_gencad.py``), and the torch
oracle of the reference loss (``tests/test_losses.py``).

The cv2 cases skip where OpenCV is missing. Float32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import TINY_CONFIG
from tests.test_losses import (CMD_WEIGHTS, _random_batch, torch_flexible_ce,
                               torch_reference_loss)
from tests.test_torch_port_model import _u8
from videocad_tpu.models import create_model as jax_create_model
from videocad_tpu.models import init_model
from videocad_tpu.models.videocadformer import VideoCADFormer as JaxModel
from videocad_tpu_torch.data.dataset import gencad_cad_image
from videocad_tpu_torch.models import create_model, state_dict_from_jax
from videocad_tpu_torch.ops import losses as port_losses
from videocad_tpu_torch.ops import preprocess as port_preprocess
from videocad_tpu_torch.train import objective as port_objective


def _structured_rgb(h=120, w=160, seed=0):
    """``tests/test_resize_gencad.py``'s image with edges (that module
    skips as a whole without cv2, so it is not imported here)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 40, np.uint8)
    img[h // 6: 2 * h // 3, w // 5: 3 * w // 5] = 200
    img[h // 2: 2 * h // 3, 2 * w // 3: 9 * w // 10] = rng.integers(
        0, 256, (2 * h // 3 - h // 2, 9 * w // 10 - 2 * w // 3, 3),
        dtype=np.uint8)
    return img


@pytest.mark.parametrize("patch_norm,final_norm", [
    (True, True), (False, False), (True, False), (False, True)])
def test_vit_generations_embed_as_jax(patch_norm, final_norm):
    """The modern vit_pytorch ViT (norms around the patch projection, a
    final norm) and the legacy one (neither), and the mixed settings: the
    same parameter tree as JAX's and its float32 frame embeddings."""
    cfg = dict(TINY_CONFIG, vit_attention_impl="fused",
               vit_patch_norm=patch_norm, vit_final_norm=final_norm)
    jax_model = jax_create_model(cfg)
    params = init_model(jax_model, jax.random.PRNGKey(3), batch=1,
                        seq_len=2)
    model = create_model(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    names = set(model.state_dict())
    assert ("state_encoder.patch_norm_in.weight" in names) == patch_norm
    assert ("state_encoder.final_norm.weight" in names) == final_norm
    frames = _u8((2, 3, 32, 32, 3), seed=2)
    want = jax_model.apply({"params": params}, jnp.asarray(frames),
                           method=JaxModel.encode_frames)
    with torch.no_grad():
        got = model.encode_frames(torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_resize_matches_cv2_linear():
    """The resize matrices (``_resize_matrix``) follow cv2.INTER_LINEAR's
    half-pixel centres, through the gray path and applied alone."""
    cv2 = pytest.importorskip("cv2")
    img = _structured_rgb(64, 96)
    out = port_preprocess.grayscale_normalize(
        torch.from_numpy(img), target_size=(32, 48))[..., 0].numpy()
    gray = img.astype(np.float32) @ np.array([0.299, 0.587, 0.114],
                                             np.float32)
    expected = cv2.resize(gray, (48, 32), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(out, expected / 127.5 - 1.0, atol=2e-3)
    for (h, w), (oh, ow) in [((64, 96), (32, 48)), ((40, 56), (24, 32)),
                             ((16, 16), (37, 23))]:
        plane = np.random.default_rng(h).random((h, w), dtype=np.float32)
        got = (port_preprocess._resize_matrix(h, oh) @ plane
               @ port_preprocess._resize_matrix(w, ow).T)
        want = cv2.resize(plane, (ow, oh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_gencad_image_matches_the_golden_pipeline():
    """Canny(100, 200) -> 3 channels -> PIL resize of the shorter edge to
    256 -> centre crop 256, computed here independently (torchvision's
    Resize / CenterCrop arithmetic)."""
    cv2 = pytest.importorskip("cv2")
    from PIL import Image

    for h, w in [(120, 160), (160, 120)]:
        img = _structured_rgb(h, w)
        got = gencad_cad_image(img)
        assert got.shape == (256, 256, 3) and got.dtype == np.uint8
        edges = cv2.Canny(img, 100, 200)
        nh, nw = (256, int(256 * w / h)) if h <= w else (int(256 * h / w),
                                                         256)
        rgb = np.repeat(edges[:, :, None], 3, axis=2)
        resized = Image.fromarray(rgb).resize((nw, nh), Image.BILINEAR)
        left, top = int(round((nw - 256) / 2.0)), int(round((nh - 256) / 2.0))
        np.testing.assert_array_equal(got, np.asarray(resized.crop(
            (left, top, left + 256, top + 256))))


@pytest.mark.parametrize("tolerance,above,ignore_valid", [
    (2, True, True), (2, False, True), (50, True, True),
    (200, True, False), (5, False, False), (500, True, True),
])
def test_flexible_ce_matches_the_torch_oracle(tolerance, above, ignore_valid):
    rng = np.random.default_rng(tolerance)
    logits = rng.normal(size=(64, 1000)).astype(np.float32)
    targets = rng.integers(-1, 1000, size=(64,))
    targets[:8] = np.argmax(logits[:8], axis=1)
    expected = torch_flexible_ce(logits, targets, 1000, tolerance, above,
                                 ignore_valid)
    got = float(port_losses.flexible_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(targets),
        tolerance=tolerance, above=above, ignore_valid=ignore_valid))
    assert abs(got - expected) < 1e-5, (got, expected)


@pytest.mark.parametrize("use_mse", [True, False])
def test_total_loss_matches_the_torch_oracle(use_mse):
    rng = np.random.default_rng(7)
    cmd_logits, param_logits, actions = _random_batch(rng)
    expected = torch_reference_loss(cmd_logits, param_logits, actions,
                                    use_mse)
    cfg = port_objective.LossConfig(cmd_weights=tuple(CMD_WEIGHTS),
                                    use_mse=use_mse)
    loss, _ = port_objective.compute_loss_and_metrics(
        torch.from_numpy(cmd_logits), torch.from_numpy(param_logits),
        torch.from_numpy(actions), cfg)
    assert abs(float(loss) - expected) < 1e-4, (float(loss), expected)
