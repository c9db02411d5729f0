"""The control and each planted fault, driven through a run's jobs and
its reference with the card's look skipped, must come out not correct;
the sound job must come out correct."""

from __future__ import annotations

import io
import json

import pytest

from benchmark.harness.faults import COMPRESSION_FAULTS, FAULTS

SHA256_FAULTS = ("control", "grumpkin_commit_altered") + COMPRESSION_FAULTS


@pytest.fixture(scope="module")
def fib_rows(tiny_manifest):
    from benchmark.control import judge
    out = io.StringIO()
    rows = judge(tiny_manifest, "fib-tiny.prove", [5], list(FAULTS), "cpu",
                 out)
    assert len(out.getvalue().splitlines()) == len(rows)
    return {r["fault"]: r for r in rows}


@pytest.fixture(scope="module")
def sha256_rows(tiny_manifest):
    from benchmark.control import judge
    rows = judge(tiny_manifest, "sha256-tiny.compressed", [6],
                 list(SHA256_FAULTS), "cpu", io.StringIO())
    return {r["fault"]: r for r in rows}


def test_sound_job_is_correct(fib_rows):
    row = fib_rows["sound"]
    assert row["correct"], row


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fib_rows, fault):
    row = fib_rows[fault]
    assert not row["correct"], json.dumps(row)


def test_control_is_caught_by_the_reference_alone(fib_rows):
    # the program's own verifier accepts the control's proof
    row = fib_rows["control"]
    assert row["numbers"]["failed_off"] == 0
    assert row["numbers"]["digest_off"] > 0


def test_grumpkin_commit_is_caught_by_its_msm(fib_rows):
    # no verifier runs in a prove-only job: the reference alone sees it
    row = fib_rows["grumpkin_commit_altered"]
    assert row["numbers"]["failed_off"] == 0
    assert row["numbers"]["commit_off"] > 0


def test_sha256_sound_job_is_correct(sha256_rows):
    assert sha256_rows["sound"]["correct"], sha256_rows["sound"]


@pytest.mark.parametrize("fault", SHA256_FAULTS)
def test_sha256_fault_is_not_correct(sha256_rows, fault):
    assert not sha256_rows[fault]["correct"], json.dumps(sha256_rows[fault])


@pytest.mark.parametrize("fault", COMPRESSION_FAULTS)
def test_compression_fault_is_caught_by_the_reference(sha256_rows, fault):
    # whatever the port's verifier says, the plain Spartan check sees it
    assert sha256_rows[fault]["numbers"]["compressed_off"] > 0, \
        json.dumps(sha256_rows[fault])


def test_dropped_transcript_entry_passes_the_ports_verifier(sha256_rows):
    row = sha256_rows["transcript_dropped"]
    assert row["numbers"]["failed_off"] == 0, json.dumps(row)
