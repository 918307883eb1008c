"""The port's four `.proto` sources against the JAX package's and its pb2s.

`gubernator_tpu_torch/api/proto/` holds copies of the reference's
`gubernator.proto`, `peers.proto`, `etcd_mvcc.proto` and `etcd_rpc.proto`
(the sources its `gen/*_pb2.py` descriptors are built from, and the
files `serve/etcd_client.py` names). Each must equal its JAX file byte
for byte, and `protoc --python_out` (found on PATH) must compile each
to the descriptor its port pb2 module holds. The shipped pb2 modules
(the JAX package's too) leave out the empty `options` protoc writes for
each service method, so those are cleared on both sides before the
compare; nothing else is.
"""

import ast
import importlib
import re
import shutil
import subprocess
from pathlib import Path

import pytest
from google.protobuf import descriptor_pb2

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "gubernator_tpu_torch" / "api" / "proto"
JAX = ROOT / "gubernator_tpu" / "api" / "proto"
PROTOS = ("gubernator", "peers", "etcd_mvcc", "etcd_rpc")


@pytest.mark.parametrize("name", PROTOS)
def test_proto_copy_equals_the_jax_source_byte_for_byte(name):
    assert (PORT / f"{name}.proto").read_bytes() == (JAX / f"{name}.proto").read_bytes()


def _without_method_options(serialized: bytes) -> descriptor_pb2.FileDescriptorProto:
    fd = descriptor_pb2.FileDescriptorProto.FromString(serialized)
    for service in fd.service:
        for method in service.method:
            method.ClearField("options")
    return fd


@pytest.mark.parametrize("name", PROTOS)
def test_protoc_compiles_each_copy_to_its_port_pb2_descriptor(name, tmp_path):
    protoc = shutil.which("protoc")
    if protoc is None:
        pytest.skip("no protoc on PATH")
    subprocess.run([protoc, f"-I{PORT}", f"--python_out={tmp_path}", f"{name}.proto"],
                   check=True, cwd=PORT, capture_output=True)
    text = (tmp_path / f"{name}_pb2.py").read_text()
    literal = re.search(r"AddSerializedFile\((b'.*?')\)\n", text, re.S).group(1)
    compiled = _without_method_options(ast.literal_eval(literal))
    shipped = importlib.import_module(f"gubernator_tpu_torch.api.proto.gen.{name}_pb2")
    held = _without_method_options(shipped.DESCRIPTOR.serialized_pb)
    assert compiled == held
    assert compiled.name == f"{name}.proto" and compiled.message_type


def test_etcd_client_names_a_proto_the_port_holds():
    text = (ROOT / "gubernator_tpu_torch" / "serve" / "etcd_client.py").read_text()
    named = set(re.findall(r"api/proto/(\w+\.proto)", text))
    assert named and all((PORT / f).is_file() for f in named)
