"""The plain reference: AES-128 and its inverse cipher against FIPS-197
and SP 800-38A, the LWE round trip, and the comparison that decides
`correct`."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.reference import aes, judge, lwe

FIPS_KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C


def hexes(rows) -> list[str]:
    return [bytes(r).hex() for r in rows]


def test_fips197_appendix_c1_encrypt():
    rk = aes.key_expansion(0x000102030405060708090A0B0C0D0E0F)
    pt = aes.to_bytes(0x00112233445566778899AABBCCDDEEFF)[None]
    assert hexes(aes.encrypt_blocks(rk, pt)) == [
        "69c4e0d86a7b0430d8cdb78070b4c55a"]


def test_fips197_appendix_c1_decrypt():
    rk = aes.key_expansion(0x000102030405060708090A0B0C0D0E0F)
    ct = aes.to_bytes(0x69C4E0D86A7B0430D8CDB78070B4C55A)[None]
    assert hexes(aes.decrypt_blocks(rk, ct)) == [
        "00112233445566778899aabbccddeeff"]


def test_decrypt_inverts_encrypt_on_random_blocks_and_keys():
    rng = np.random.default_rng(20)
    blocks = rng.integers(0, 256, size=(1000, 16), dtype=np.uint8)
    for i, key in enumerate(int.from_bytes(rng.bytes(16), "big")
                            for _ in range(1000)):
        rk = aes.key_expansion(key)
        pt = blocks[i:i + 1]
        ct = aes.encrypt_blocks(rk, pt)
        assert (aes.decrypt_blocks(rk, ct) == pt).all(), key
        assert not (ct == pt).all()


def test_fips197_appendix_a1_key_expansion():
    rk = aes.key_expansion(FIPS_KEY)
    assert rk.shape == (11, 16)
    assert hexes(rk[[0, 1, 2, 10]]) == [
        "2b7e151628aed2a6abf7158809cf4f3c",
        "a0fafe1788542cb123a339392a6c7605",
        "f2c295f27a96b9435935807a7359f67f",
        "d014f9a8c9ee2589e13f0cc8b6630ca6"]


def test_fips197_appendix_b_cipher():
    rk = aes.key_expansion(FIPS_KEY)
    pt = aes.to_bytes(0x3243F6A8885A308D313198A2E0370734)[None]
    assert hexes(aes.encrypt_blocks(rk, pt)) == [
        "3925841d02dc09fbdc118597196a0b32"]


def test_sp800_38a_ctr_keystream_and_counter_wrap():
    # SP 800-38A F.5.1: the keystream is the encrypted counter blocks.
    ks = aes.ctr_keystream(FIPS_KEY, 0xF0F1F2F3F4F5F6F7F8F9FAFBFCFDFEFF, 0, 4)
    assert hexes(ks) == ["ec8cdf7398607cb0f2d21675ea9ea1e4",
                         "362b7c3c6773516318a077d7fc5073ae",
                         "6a2cc3787889374fbeb4c81b17ba6c44",
                         "e89c399ff0f198c6d40a31db156cabfe"]
    top = (1 << 128) - 1
    wrapped = aes.ctr_keystream(FIPS_KEY, top, 1, 1)
    assert (wrapped == aes.ctr_keystream(FIPS_KEY, 0, 0, 1)).all()


def test_bits_least_significant_first():
    assert aes.bits_of(np.array([0b10000001, 2], np.uint8)).tolist() == [
        [1, 0, 0, 0, 0, 0, 0, 1], [0, 1, 0, 0, 0, 0, 0, 0]]


def test_lwe_round_trip_and_errors():
    rng = np.random.default_rng(5)
    _, glwe = lwe.draw_secret_keys(rng, 16, 2, 64)
    key = glwe.reshape(-1)
    bits = rng.integers(0, 2, size=(3, 8), dtype=np.uint64)
    cts = lwe.encrypt_bits(key, bits, 2.0 ** -30, rng)
    assert cts.shape == (3, 8, 129) and cts.dtype == np.uint64
    wrong, err = lwe.decrypt(key, cts, bits)
    assert wrong == 0 and err.shape == (3, 8)
    assert np.abs(err).max() < 2.0 ** 40           # 2^34 sigma
    flipped = cts.copy()
    flipped[1, 2, -1] += np.uint64(1 << 63)
    wrong, err = lwe.decrypt(key, flipped, bits)
    assert wrong == 1 and abs(err[1, 2]) > 2.0 ** 62
    assert lwe.decrypt(key, cts, 1 - bits)[0] == 24


def test_budget_sigma_matches_the_noise_budget():
    # p_fail 2^-64 needs 9.15 sigma under the threshold 2^62: 2^58.81.
    assert np.log2(judge.budget_sigma(2.0 ** -64)) == pytest.approx(58.81,
                                                                    abs=0.01)


def _answers(seed: int, blocks: int):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 2, size=128, dtype=np.uint64)
    k, iv = 0x1234, (1 << 128) - 2
    want = aes.bits_of(aes.ctr_keystream(k, iv, 3, blocks))
    ks = lwe.encrypt_bits(key, want, 2.0 ** -20, rng)
    rks = lwe.encrypt_bits(key, aes.bits_of(aes.key_expansion(k)),
                           2.0 ** -20, rng)
    return key, k, iv, ks, rks


def test_judge_passes_right_answers_and_fails_a_flipped_bit():
    key, k, iv, ks, rks = _answers(1, 2)
    j = judge.Judge(key, 2.0 ** -64)
    j.keystream(ks, k, iv, 3)
    j.schedule(rks, k)
    checks, failed = j.verdict()
    assert judge.passed(checks) and failed == [False]
    assert checks["noise_share"]["value"] < 1e-4
    assert list(checks) == ["wrong_bits", "noise_share"]
    for where in ("keystream", "schedule"):
        j = judge.Judge(key, 2.0 ** -64)
        bad_ks, bad_rks = ks.copy(), rks.copy()
        (bad_ks if where == "keystream" else bad_rks)[1, 5, 3, -1] += \
            np.uint64(1 << 63)
        j.keystream(bad_ks, k, iv, 3)
        j.schedule(bad_rks, k)
        checks, _ = j.verdict()
        assert checks["wrong_bits"]["value"] == 1 and not judge.passed(checks)


def test_judge_compares_inverse_cipher_answers_with_their_plaintexts():
    rng = np.random.default_rng(4)
    key = rng.integers(0, 2, size=128, dtype=np.uint64)
    plain = rng.integers(0, 256, size=(3, 16), dtype=np.uint8)
    right = lwe.encrypt_bits(key, aes.bits_of(plain), 2.0 ** -20, rng)
    ks = lwe.encrypt_bits(key, aes.bits_of(aes.ctr_keystream(7, 9, 0, 1)),
                          2.0 ** -20, rng)
    j = judge.Judge(key, 2.0 ** -64)
    j.decrypt(right, plain)
    j.keystream(ks, 7, 9, 0)
    checks, failed = j.verdict()
    assert judge.passed(checks) and failed == [False, False]
    assert 0 < checks["noise_share"]["value"] < 1e-4
    j = judge.Judge(key, 2.0 ** -64)
    j.keystream(ks, 7, 9, 0)
    j.decrypt(right[[1, 0, 2]], plain)
    checks, failed = j.verdict()
    assert failed == [False, True] and not judge.passed(checks)
    assert checks["wrong_bits"]["value"] == int(np.sum(
        aes.bits_of(plain[0]) != aes.bits_of(plain[1])) * 2)


def test_judge_fails_noise_past_the_budget_and_no_answer():
    key, k, iv, _, _ = _answers(2, 1)
    rng = np.random.default_rng(3)
    want = aes.bits_of(aes.ctr_keystream(k, iv, 0, 4))
    # Two budget sigmas: almost every bit still decrypts right.
    noisy = lwe.encrypt_bits(key, want, 2 * judge.budget_sigma(2.0 ** -64)
                             / 2.0 ** 64, rng)
    j = judge.Judge(key, 2.0 ** -64)
    j.keystream(noisy, k, iv, 0)
    checks, _ = j.verdict()
    assert checks["noise_share"]["value"] == pytest.approx(2.0, rel=0.1)
    assert not judge.passed(checks)
    empty, _ = judge.Judge(key, 2.0 ** -64).verdict()
    assert empty["noise_share"]["value"] is None and not judge.passed(empty)
