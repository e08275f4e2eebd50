"""tests/test_spectrum.py's gates (pbrt spectrum_test.cpp) on the port's
spectra (utils/spectrum.py, utils/colorspace.py, the parser's named
spectra), thresholds unchanged.  The reference's two sigmoid-polynomial
tests are held in tests/test_torch_tools.py."""
import numpy as np
import torch

from acceleratedvolrenderer_tpu_torch.utils import colorspace as cs
from acceleratedvolrenderer_tpu_torch.utils import spectrum as sp


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_cie_y_integral():
    lam = torch.arange(sp.LAMBDA_MIN, sp.LAMBDA_MAX + 1.0, 1.0)
    integral = float(torch.sum(sp.cie_y(lam)))
    assert abs(integral - sp.CIE_Y_INTEGRAL) / sp.CIE_Y_INTEGRAL < 0.015


def test_sample_wavelengths_in_range():
    u = torch.linspace(0.0, 0.999, 64)
    swl = sp.sample_wavelengths_uniform(u)
    assert swl.lam.shape == (64, sp.N_SPECTRUM_SAMPLES)
    assert float(swl.lam.min()) >= sp.LAMBDA_MIN
    assert float(swl.lam.max()) <= sp.LAMBDA_MAX
    np.testing.assert_allclose(swl.pdf.numpy(),
                               1.0 / (sp.LAMBDA_MAX - sp.LAMBDA_MIN),
                               rtol=1e-6)
    swl_v = sp.sample_wavelengths_visible(u)
    assert float(swl_v.lam.min()) >= sp.LAMBDA_MIN - 1.0
    assert float(swl_v.lam.max()) <= sp.LAMBDA_MAX + 1.0
    assert float(swl_v.pdf.min()) > 0.0


def test_visible_pdf_normalized():
    lam = torch.arange(sp.LAMBDA_MIN, sp.LAMBDA_MAX + 1.0, 0.5)
    assert abs(float(torch.sum(sp._visible_pdf(lam)) * 0.5) - 1.0) < 1e-2


def test_constant_spectrum_to_xyz_white():
    u = torch.rand(4096, generator=torch.Generator().manual_seed(0))
    swl = sp.sample_wavelengths_visible(u)
    mean_xyz = torch.mean(sp.to_xyz(torch.ones_like(swl.lam), swl),
                          dim=0).numpy()
    assert abs(mean_xyz[1] - 1.0) < 0.02, mean_xyz


def test_terminate_secondary():
    swl = sp.sample_wavelengths_uniform(_t([0.3]))
    t = swl.terminate_secondary()
    assert np.all(t.pdf[..., 1:].numpy() == 0.0)
    np.testing.assert_allclose(t.pdf[..., 0].numpy(),
                               swl.pdf[..., 0].numpy() / sp.N_SPECTRUM_SAMPLES)
    np.testing.assert_allclose(t.terminate_secondary().pdf.numpy(),
                               t.pdf.numpy())


def test_rgb_albedo_roundtrip_gray():
    vals = sp.rgb_albedo_spectrum([0.5, 0.5, 0.5])(
        torch.linspace(420.0, 680.0, 64)).numpy()
    assert np.all(vals > 0.4) and np.all(vals < 0.6)


def test_blackbody_wien_peak():
    lam = torch.arange(sp.LAMBDA_MIN, sp.LAMBDA_MAX, 1.0)
    v = sp.blackbody_normalized(6000.0)(lam).numpy()
    peak_lam = float(lam[np.argmax(v)])
    assert abs(peak_lam - 2.8977721e-3 / 6000.0 * 1e9) < 2.0
    assert abs(v.max() - 1.0) < 1e-3
    # a luminous scale exists for it (pbrt SpectrumToPhotometric)
    assert sp.spectrum_to_photometric(sp.blackbody_normalized(6000.0)) > 0


def test_srgb_roundtrip():
    rgb = _t(np.random.default_rng(0).random((32, 3)))
    back = cs.xyz_to_rgb(cs.rgb_to_xyz(rgb))
    np.testing.assert_allclose(back.numpy(), rgb.numpy(), atol=1e-4)


def test_named_glass_bk7_sellmeier():
    f = sp.named_spectrum("glass-BK7")
    assert abs(float(f(_t([587.6]))[0]) - 1.5168) < 2e-3
    n = f(_t([400.0, 550.0, 700.0])).numpy()
    assert n[0] > n[1] > n[2]


def test_named_metal_gold():
    lam = _t([450.0, 650.0])
    e = sp.named_spectrum("metal-Au-eta")(lam).numpy()
    kk = sp.named_spectrum("metal-Au-k")(lam).numpy()
    assert e[0] > 1.0 and e[1] < 0.2
    assert kk[1] > 3.0

    def R(n_, k_):
        return ((n_ - 1) ** 2 + k_ ** 2) / ((n_ + 1) ** 2 + k_ ** 2)
    assert R(e[1], kk[1]) > R(e[0], kk[0]) + 0.3


def test_named_illuminants_and_unknown():
    assert sp.named_spectrum("stdillum-A") is not None
    assert sp.named_spectrum("stdillum-D65") is not None
    assert sp.named_spectrum("no-such-spectrum") is None
    dense = sp.DenselySampledSpectrum(
        sp.named_spectrum("stdillum-D65")(torch.arange(
            sp.LAMBDA_MIN, sp.LAMBDA_MAX + 1.0, 1.0)), device="cpu")
    np.testing.assert_allclose(
        dense(_t([500.2, 600.0])).numpy(),
        sp.named_spectrum("stdillum-D65")(_t([500.0, 600.0])).numpy(),
        rtol=1e-6)


def test_parser_named_spectrum_conductor(tmp_path):
    from acceleratedvolrenderer_tpu_torch.scene.parser import PbrtParser

    f = tmp_path / "au.pbrt"
    f.write_text('''
WorldBegin
Material "conductor" "spectrum eta" ["metal-Au-eta"]
    "spectrum k" ["metal-Au-k"]
Shape "sphere" "float radius" [1]
''')
    sc = PbrtParser(device="cpu").parse_file(str(f))
    m = sc.primitives[0].material
    assert m.eta(_t([650.0])).numpy()[0] < 0.2
