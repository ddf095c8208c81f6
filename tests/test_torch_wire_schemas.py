"""The port's ``WIRE_SCHEMAS`` against the JAX package's, the table's own
checks (those of the JAX ``tests/test_wire_schemas.py`` that need no
handler sites of the JAX planes), and the table against the port's code:
it holds exactly the codes the port's modules name, the server holds back
the acks of its ``wal_before_ack`` codes only, and ``ReliableTransport``'s
best-effort codes are its ``best_effort`` ones.

The port's ``doc`` texts are the JAX ones without the JAX project's change
references (a word in capitals and a number, in parentheses or in a
"pre-" prefix); :func:`_without_change_refs` removes exactly those from the
JAX text before the comparison. Every other field is compared as it is.
"""

import ast
import dataclasses
import inspect
import pathlib
import re

import pytest

import distributed_ml_pytorch_tpu_torch
from distributed_ml_pytorch_tpu.utils import messaging as jmsg
from distributed_ml_pytorch_tpu_torch.parallel.async_ps import _ack_waits_for_wal
from distributed_ml_pytorch_tpu_torch.utils import messaging as tmsg
from distributed_ml_pytorch_tpu_torch.utils.messaging import (
    DEDUP_KEYS,
    DELIVERY,
    DURABILITY,
    WIRE_SCHEMAS,
    MessageCode,
    PayloadSchema,
    ReliableTransport,
)


#: a change reference of the JAX project: a five-letter capitalised word and
#: its number
_REF = r"[A-Z]{5}"


def _without_change_refs(doc: str) -> str:
    doc = re.sub(r" \(" + _REF + r" \d+\)", "", doc)
    doc = re.sub(r"\(" + _REF + r" \d+[,:] ", "(", doc)
    doc = re.sub(r"pre-" + _REF + r"-[\d/]+", "older", doc)
    return re.sub(r"\b" + _REF + r"-\d+ ", "", doc)


def test_codes_equal_jax_name_for_name():
    assert {m.name: int(m) for m in MessageCode} == {m.name: int(m) for m in jmsg.MessageCode}


@pytest.mark.parametrize("name", [c.name for c in WIRE_SCHEMAS])
def test_schema_equals_jax_field_for_field(name):
    mine = dataclasses.asdict(WIRE_SCHEMAS[MessageCode[name]])
    ref = dataclasses.asdict(jmsg.WIRE_SCHEMAS[jmsg.MessageCode[name]])
    ref["doc"] = _without_change_refs(ref["doc"])
    assert re.search(_REF + r"[ -]\d+", mine["doc"]) is None
    assert mine == ref
    assert (WIRE_SCHEMAS[MessageCode[name]].min_size
            == jmsg.WIRE_SCHEMAS[jmsg.MessageCode[name]].min_size)


def test_vocabularies_equal_jax():
    assert (DEDUP_KEYS, DURABILITY, DELIVERY) == (jmsg.DEDUP_KEYS, jmsg.DURABILITY,
                                                  jmsg.DELIVERY)
    assert [f.name for f in dataclasses.fields(PayloadSchema)] == [
        f.name for f in dataclasses.fields(jmsg.PayloadSchema)]


@pytest.mark.parametrize("kwargs,word", [
    (dict(dedup_key="vibes"), "dedup_key"),
    (dict(durability="hopes"), "durability"),
    (dict(delivery="carrier-pigeon"), "delivery"),
    (dict(rest="tail", rest_sections=("a", "b")), "rest_separator"),
])
def test_vocabulary_checks_raise_as_jax(kwargs, word):
    for schema in (PayloadSchema, jmsg.PayloadSchema):
        with pytest.raises(ValueError, match=word):
            schema(**kwargs)
    # a valid multi-section tail passes in both
    for schema in (PayloadSchema, jmsg.PayloadSchema):
        schema(rest="tail", rest_sections=("a", "b"), rest_separator=-1.0)


def _codes_named_by_the_port():
    """Every ``MessageCode.X`` a module of the port names, outside the
    table itself."""
    names = set()
    root = pathlib.Path(distributed_ml_pytorch_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        tree = ast.parse(path.read_text())
        skip = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            else:
                continue
            if any(isinstance(t, ast.Name) and t.id == "WIRE_SCHEMAS" for t in targets):
                skip.update(id(n) for n in ast.walk(node))
        for node in ast.walk(tree):
            if (id(node) not in skip and isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name) and node.value.id == "MessageCode"):
                names.add(node.attr)
    return names


def test_the_table_holds_exactly_the_codes_the_port_names():
    named = _codes_named_by_the_port()
    assert {"GradientUpdate", "ReliableFrame", "SubmitRequest"} <= named
    missing = sorted(named - {c.name for c in WIRE_SCHEMAS})
    assert not missing, f"codes the port names without a WIRE_SCHEMAS entry: {missing}"
    unused = sorted({c.name for c in WIRE_SCHEMAS} - named)
    assert not unused, f"WIRE_SCHEMAS entries no module of the port names: {unused}"
    ghosts = [c for c in WIRE_SCHEMAS if not isinstance(c, MessageCode)]
    assert not ghosts, f"schemas for non-enum keys: {ghosts}"


def test_the_server_holds_back_exactly_the_wal_before_ack_codes():
    """The port's servers read the table where the JAX servers name their
    gradient codes (``GradientUpdate``, ``CompressedUpdate``, and the
    elastic server's ``ShardPush``): on the codes the port speaks the two
    agree, and a code outside the table commits at once."""
    for code in WIRE_SCHEMAS:
        assert _ack_waits_for_wal(code) == (
            code in (MessageCode.GradientUpdate, MessageCode.CompressedUpdate,
                     MessageCode.ShardPush)), code.name
    assert not _ack_waits_for_wal(MessageCode.RollbackDone)


def test_code_values_are_collision_free():
    members = MessageCode.__members__
    assert len({int(v) for v in members.values()}) == len(members)


def test_handled_by_planes_are_known_and_nonempty():
    valid = {"ps", "serving", "coord", "transport"}
    for code, schema in WIRE_SCHEMAS.items():
        assert schema.handled_by, f"{code.name}: empty handled_by"
        assert set(schema.handled_by) <= valid, code.name


def test_every_reliable_code_declares_a_dedup_key():
    bare = [c.name for c, s in WIRE_SCHEMAS.items()
            if s.delivery == "reliable" and s.dedup_key is None]
    assert not bare, bare


def test_annotations_stay_inside_their_vocabularies():
    for code, s in WIRE_SCHEMAS.items():
        assert s.dedup_key is None or s.dedup_key in DEDUP_KEYS, code.name
        assert s.durability in DURABILITY, code.name
        assert s.delivery in DELIVERY, code.name


def test_durability_only_decorates_reliable_wal_codes():
    for code, s in WIRE_SCHEMAS.items():
        if s.durability == "wal_before_ack":
            assert s.delivery == "reliable", code.name
            assert s.dedup_key == "env_seq", code.name


@pytest.mark.parametrize("pkg", [tmsg, jmsg], ids=["port", "jax"])
def test_best_effort_annotation_matches_unreliable_codes_default(pkg):
    sig = inspect.signature(pkg.ReliableTransport.__init__)
    default = {int(c) for c in sig.parameters["unreliable_codes"].default}
    annotated = {int(c) for c, s in pkg.WIRE_SCHEMAS.items() if s.delivery == "best_effort"}
    assert annotated == default
    assert int(MessageCode.Heartbeat) in default


def test_envelope_codes_are_exactly_the_reliability_wire():
    annotated = {c.name for c, s in WIRE_SCHEMAS.items() if s.delivery == "envelope"}
    assert annotated == {"ReliableFrame", "ReliableAck", "CumAck"}


def test_the_envelope_header_is_the_schemas_fields():
    """The reliable layer's header and acks have the layouts the table
    declares: a ReliableFrame's head is 9 floats, a ReliableAck 4, a CumAck
    5."""
    assert WIRE_SCHEMAS[MessageCode.ReliableFrame].min_size == 9
    assert WIRE_SCHEMAS[MessageCode.ReliableAck].min_size == 4
    assert WIRE_SCHEMAS[MessageCode.CumAck].min_size == 5
    assert tmsg._split16(0xABCD1234) == jmsg._split16(0xABCD1234) == (0x1234, 0xABCD)
    assert tmsg._join16(0x1234, 0xABCD) == 0xABCD1234


def test_the_barrier_codes_are_in_and_only_the_later_planes_codes_are_out():
    """The snapshot and rollback barriers' four codes, the scheduler's four
    and the MPMD stage plane's three have their JAX schemas: the table holds
    all 41 of the JAX codes, none is left out."""
    barrier = {"SnapshotRequest", "SnapshotDone", "RollbackRequest", "RollbackDone"}
    sched = {"PreemptRequest", "PreemptDone", "SlotGrant", "ResumeRequest"}
    stages = {"ActivationShip", "ActivationGrad", "StageReady", "StageAssign"}
    assert barrier | sched | stages <= {c.name for c in WIRE_SCHEMAS}
    assert (len(WIRE_SCHEMAS), len(jmsg.WIRE_SCHEMAS)) == (41, 41)
    assert {c.name for c in jmsg.WIRE_SCHEMAS} == {c.name for c in WIRE_SCHEMAS}
    assert WIRE_SCHEMAS[MessageCode.StageAssign].fenced
    assert WIRE_SCHEMAS[MessageCode.SnapshotRequest].fenced
    assert WIRE_SCHEMAS[MessageCode.RollbackRequest].fenced
    assert WIRE_SCHEMAS[MessageCode.RollbackDone].min_size == 10
    assert WIRE_SCHEMAS[MessageCode.SnapshotDone].min_size == 12
