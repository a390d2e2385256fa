"""Offline tests for the data tooling (reference C22 CAMMiQ-download and
C23 CAMMiQ-preprocess ports): map-file surgery, genus rollup against a
synthetic taxdump, assembly-summary parsing/dedup, and map emission."""

import os

import pytest

from cammiq_tpu.tools import download as dl
from cammiq_tpu.tools import preprocess as pp


def write(path, text):
    with open(path, "w") as f:
        f.write(text)


MAP = (
    "g1.fna\t1\t100\tAlpha one\n"
    "g2.fna\t2\t200\tBeta two\n"
    "g3.fna\t2\t200\tBeta two\n"
)


def test_preprocess_add_del_merge_sort(tmp_path):
    mp = str(tmp_path / "map.out")
    write(mp, MAP)

    out = str(tmp_path / "out.out")
    pp.main(["--map_fn", mp, "--output_fn", out,
             "--add_genome", "g4.fna", "300", "Gamma three"])
    rows = [l.split("\t") for l in open(out).read().splitlines()]
    assert rows[-1] == ["g4.fna", "3", "300", "Gamma three"]
    # ids are renumbered 1..n grouped by taxid
    assert [r[1] for r in rows] == ["1", "2", "2", "3"]

    pp.main(["--map_fn", out, "--output_fn", out, "--del_genome", "g2.fna"])
    rows = [l.split("\t") for l in open(out).read().splitlines()]
    assert [r[0] for r in rows] == ["g1.fna", "g3.fna", "g4.fna"]

    # adding an existing file is a no-op (warns)
    pp.main(["--map_fn", out, "--output_fn", out,
             "--add_genome", "g1.fna", "999", "Dup"])
    rows = [l.split("\t") for l in open(out).read().splitlines()]
    assert rows[0][2] == "100"

    # merge: --map_fn rows win over --merge_map rows for the same file
    m2 = str(tmp_path / "map2.out")
    write(m2, "g1.fna\t1\t111\tOther alpha\ng9.fna\t2\t900\tNine\n")
    merged = str(tmp_path / "merged.out")
    pp.main(["--map_fn", out, "--output_fn", merged, "--merge_map", m2])
    got = {l.split("\t")[0]: l.split("\t")[2]
           for l in open(merged).read().splitlines()}
    assert got["g1.fna"] == "100" and got["g9.fna"] == "900"

    # sort_id renumbers 1..n in file order grouped by taxid
    mp3 = str(tmp_path / "map3.out")
    write(mp3, "a.fna\t7\t500\tA\nb.fna\t9\t600\tB\nc.fna\t7\t500\tA\n")
    pp.main(["--map_fn", mp3, "--sort_id"])
    rows = [l.split("\t") for l in open(mp3).read().splitlines()]
    assert [r[1] for r in rows] == ["1", "2", "1"]


def test_preprocess_genus_rollup(tmp_path):
    # synthetic taxonomy: 1 <- 10(genus) <- 20(species) <- 30(strain)
    #                     1 <- 40(family) <- 50(species)  (no genus level)
    parents = {"10": "1", "20": "10", "30": "20", "40": "1", "50": "40"}
    ranks = {"10": "genus", "20": "species", "30": "strain",
             "40": "family", "50": "species"}
    gm = {"x.fna": ("30", "Strain thirty"), "y.fna": ("50", "Species fifty")}
    gid_map = pp.convert_to_genus(gm, parents, ranks)
    # 30 -> 20 -> 10 stops at genus (weight 0); 50 -> 40 stops at family
    # (weight 1, first >= 0 ancestor — reference walks until weight >= 0)
    assert gid_map == {"30": "10", "50": "40"}

    out = str(tmp_path / "rolled.out")
    pp.output_map(gm, out, gid_map=gid_map,
                  names={"10": "Genus ten", "40": "Family forty"})
    rows = [l.split("\t") for l in open(out).read().splitlines()]
    assert rows[0] == ["x.fna", "1", "10", "Genus ten"]
    assert rows[1] == ["y.fna", "2", "40", "Family forty"]


SUMMARY = "\n".join([
    "#  header",
    "# assembly_accession\tbioproject\t...",
    # acc, ..cat(4), taxid(5), species_taxid(6), name(7), ..level(11), ..ftp(19)
    "\t".join(["GCF_1", "x", "x", "x", "na", "101", "100", "Eco one", "x", "x",
               "x", "Complete Genome", "x", "x", "x", "x", "x", "x", "x",
               "ftp://host/path/GCF_1v1"]),
    "\t".join(["GCF_2", "x", "x", "x", "reference genome", "102", "100",
               "Eco two", "x", "x", "x", "Complete Genome", "x", "x", "x",
               "x", "x", "x", "x", "ftp://host/path/GCF_2v1"]),
    "\t".join(["GCF_3", "x", "x", "x", "na", "201", "200", "Sal one", "x", "x",
               "x", "Scaffold", "x", "x", "x", "x", "x", "x", "x",
               "ftp://host/path/GCF_3v1"]),
    "\t".join(["GCF_4", "x", "x", "x", "na", "202", "200", "Sal two", "x", "x",
               "x", "Complete Genome", "x", "x", "x", "x", "x", "x", "x",
               "ftp://host/path/GCF_4v1"]),
    "",
])


def test_download_parse_and_map(tmp_path):
    p = str(tmp_path / "assembly_summary.txt")
    write(p, SUMMARY)

    rows = dl.parse_assembly_summary(p, complete_only=True, dedup=False)
    assert [r["accession"] for r in rows] == ["GCF_1", "GCF_2", "GCF_4"]

    rows = dl.parse_assembly_summary(p, complete_only=True, dedup=True)
    # species 100 keeps the reference genome; species 200 keeps its only
    # complete assembly
    got = {r["species_taxid"]: r["accession"] for r in rows}
    assert got == {"100": "GCF_2", "200": "GCF_4"}

    rows = dl.parse_assembly_summary(p, complete_only=False, dedup=False)
    assert len(rows) == 4

    mp = str(tmp_path / "genome_map.out")
    dl.write_map(dl.parse_assembly_summary(p, True, False), mp)
    lines = [l.split("\t") for l in open(mp).read().splitlines()]
    # grouped 1..n by species taxid; filename derived from ftp basename
    assert lines[0] == ["GCF_1v1_genomic.fna", "1", "100", "Eco one"]
    assert lines[1] == ["GCF_2v1_genomic.fna", "1", "100", "Eco two"]
    assert lines[2] == ["GCF_4v1_genomic.fna", "2", "200", "Sal two"]


def test_download_cli_no_fetch(tmp_path):
    p = str(tmp_path / "assembly_summary.txt")
    write(p, SUMMARY)
    mp = str(tmp_path / "genome_map.out")
    dl.main(["--summary", p, "--map", mp, "--out", str(tmp_path / "g"),
             "--no-fetch"])
    assert os.path.exists(mp)
    assert len(open(mp).read().splitlines()) == 2


def _sim_db(tmp_path, rng):
    """Three two-contig genomes, one with N runs, one with lowercase."""
    import numpy as np

    rows, seqs = [], {}
    for i in range(3):
        seq = bytearray(rng.choice(list(b"ACGT"), size=3000)
                        .astype(np.uint8).tobytes())
        if i == 0:
            seq[500:520] = b"N" * 20
        if i == 2:
            seq[100:200] = bytes(seq[100:200]).lower()
        fn = f"g{i}.fa"
        (tmp_path / fn).write_bytes(b">c0\n" + bytes(seq[:1600]) + b"\n>c1\n"
                                    + bytes(seq[1600:]) + b"\n")
        seqs[str(i + 1)] = [bytes(seq[:1600]), bytes(seq[1600:])]
        rows.append(f"{fn}\t{i + 1}\t{100 + i}\tn{i}\n")
    (tmp_path / "map.out").write_text("".join(rows))
    return seqs


@pytest.mark.parametrize("erate,nrate,l_std",
                         [(0.0, 0.0, 0.0), (0.05, 0.0, 0.0),
                          (0.02, 0.01, 8.0)])
def test_simulate_headers_describe_reads(tmp_path, erate, nrate, l_std):
    """Every read is its contig slice at rpos (reverse-complemented when
    rc1) with exactly the substitutions its header lists, plus Ns."""
    import numpy as np

    from cammiq_tpu.tools import simulate as sim

    seqs = _sim_db(tmp_path, np.random.default_rng(1))
    sim.simulate(str(tmp_path / "map.out"), str(tmp_path),
                 str(tmp_path / "r.fq"), str(tmp_path / "t.out"),
                 num_reads=400, erate=erate, nrate=nrate, L_std=l_std,
                 seed=5)
    lines = (tmp_path / "r.fq").read_text().splitlines()
    n_err = 0
    for hdr, read in zip(lines[0::4], lines[1::4]):
        f = hdr[1:].split()
        gid, ci, rpos = f[0], int(f[1][1:]), int(f[3][4:])
        ref = seqs[gid][ci][rpos:rpos + len(read)]
        assert ref.translate(None, b"ACGT") == b""
        if f[4] == "rc1":
            ref = sim.rc(ref)
        want = bytearray(ref)
        for pos, sub in zip(f[5::2], f[6::2]):
            orig, new = sub.split(":")
            p = int(pos[1:])
            assert chr(want[p]) == orig and new != orig
            want[p] = ord(new)
            n_err += 1
        got = read.encode()
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a == b or (nrate > 0 and a == ord("N"))
    assert (n_err > 0) == (erate > 0)


def test_simulate_rc_is_reverse_complement():
    from cammiq_tpu.tools import simulate as sim

    assert sim.rc(b"AACGTN") == b"NACGTT"
    assert sim.rc(b"acgt") == b"ACGT"
    assert sim.rc(sim.rc(b"GATTACA")) == b"GATTACA"


def _add_errors_loop(read, rng, erate, nrate):
    """The per-base loop add_errors replaced: the reference stream."""
    from cammiq_tpu.tools.simulate import SUBS

    errs = []
    for pos in range(len(read)):
        e = rng.random()
        if e < erate:
            orig = chr(read[pos])
            sub = SUBS.get(orig, "ACG")[int(3 * e / erate) % 3]
            errs.append((pos, orig, sub))
            read[pos] = ord(sub)
    if nrate > 0:
        for pos in range(len(read)):
            if rng.random() < nrate:
                read[pos] = ord("N")
    return errs


@pytest.mark.parametrize("erate,nrate", [(0.0, 0.0), (0.01, 0.0),
                                         (0.2, 0.05)])
def test_add_errors_matches_per_base_loop(erate, nrate):
    """Same reads, same substitutions and the same RNG state after, as a
    draw per base."""
    import numpy as np

    from cammiq_tpu.tools.simulate import add_errors

    src = np.random.default_rng(0)
    for seed in range(50):
        base = bytearray(src.choice(list(b"ACGT"), size=100)
                         .astype(np.uint8).tobytes())
        a, b = bytearray(base), bytearray(base)
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        assert add_errors(a, ra, erate, nrate) == _add_errors_loop(
            b, rb, erate, nrate)
        assert a == b
        assert ra.random() == rb.random()
