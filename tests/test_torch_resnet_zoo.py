"""The vision model zoo of the PyTorch/CUDA port
(`gluon.model_zoo.vision`) against the JAX package's: ResNet-50 v1 and
v2's structural parameter names, shapes and ``grad_req`` (running
stats included) equal the JAX package's ``_collect_params_with_prefix()``
after one JAX forward (B=1, 32x32, classes=10); ``get_model`` builds
the ported names and raises `MXNetError` for the others;
``pretrained=True`` raises.  (The nets' numbers against the JAX
package: `test_torch_resnet.py`.)"""
import jax.numpy as jnp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu_torch import MXNetError
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision


@pytest.mark.parametrize("name", ["resnet50_v1", "resnet50_v2"])
def test_resnet50_names_and_shapes_match_jax(name):
    """Every structural name and shape of the port's ResNet-50, in
    order, equals the JAX net's after its first forward resolved the
    deferred shapes: the stride on the bottleneck's first 1x1 (bias
    kept), v2's input BatchNorm with gamma and beta fixed."""
    jnet = jvision.get_model(name, classes=10)
    jnet.initialize(mx.init.Zero())
    jnet(NDArray(jnp.zeros((1, 3, 32, 32))))
    want = [(k, tuple(p.shape), p.grad_req)
            for k, p in jnet._collect_params_with_prefix().items()]
    tnet = vision.get_model(name, classes=10, device="cpu")
    got = [(k, tuple(p.shape), p.grad_req)
           for k, p in tnet.named_parameters()]
    assert got == want
    with torch.no_grad():
        tnet.initialize()
        assert tnet(torch.zeros(1, 3, 32, 32)).shape == (1, 10)


def test_get_model_routes_only_ported_names():
    """A ported name builds its net (names are case-blind); every other
    name of the JAX package's zoo, or an unknown one, raises
    `MXNetError`; so does ``pretrained=True``."""
    net = vision.get_model("ResNet18_v1", classes=7, device="cpu")
    assert isinstance(net, vision.ResNetV1) and net.output.weight.shape[0] == 7
    for name in ("vgg16", "lenet", "mobilenet1.0", "inceptionv3", "nope"):
        with pytest.raises(MXNetError, match="not ported"):
            vision.get_model(name)
    with pytest.raises(MXNetError):
        vision.resnet50_v1(pretrained=True, device="cpu")
