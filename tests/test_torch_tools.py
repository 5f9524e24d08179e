"""The SASS counter of the port's tools (mjpeg423_tpu_torch/tools/
sass_count.py) on a small listing in cuobjdump's format: the main loop is
the longest backward branch, a conditional forward branch forks the path,
and instructions are binned by the unit that takes them.  The measurement
scripts need the card; here they only have to import without one."""
import importlib.util
import pathlib

import pytest

from mjpeg423_tpu_torch.tools import sass_count as sc

LISTING = """
	code for sm_90a
		Function : _Z6kernelPi
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                    /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;                        /* 0x0000000000007919 */
        /*0020*/                   IMAD R2, R0, 0x3, R1 ;                    /* 0x0000000300027824 */
        /*0030*/                   LDS.U16 R3, [R2] ;                        /* 0x0000000002037984 */
        /*0040*/                   ISETP.NE.AND P0, PT, R3, RZ, PT ;         /* 0x000000ff0300720c */
        /*0050*/               @P0 BRA 0x80 ;                                /* 0x0000000000080947 */
        /*0060*/                   IADD3 R3, R3, 0x1, RZ ;                   /* 0x0000000103037810 */
        /*0070*/                   SHF.R.S32.HI R3, RZ, 0x2, R3 ;            /* 0x00000002ff037819 */
        /*0080*/                   IMAD.IADD R2, R2, 0x1, R3 ;               /* 0x0000000102027824 */
        /*0090*/                   STG.E [R4.64], R2 ;                       /* 0x0000000204007986 */
        /*00a0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;             /* 0x0000000000007b1d */
        /*00b0*/              @!P1 BRA 0x20 ;                                /* 0xfffffff400dc9947 */
        /*00c0*/                   EXIT ;                                    /* 0x000000000000794d */
        /*00d0*/                   BRA 0xd0;                                 /* 0xfffffffc00fc7947 */
		Function : _Z5plainPi
        /*0000*/                   IABS R0, R1 ;                             /* 0x0000000100007213 */
        /*0010*/                   IMAD.HI.U32 R0, R0, R2, RZ ;              /* 0x0000000200007227 */
        /*0020*/                   CALL.REL.NOINC 0x100 ;                    /* 0x0000000000007944 */
        /*0030*/                   EXIT ;                                    /* 0x000000000000794d */
"""


def test_parse_finds_functions_predicates_and_opcodes():
    funcs = sc.parse(LISTING)
    assert list(funcs) == ["_Z6kernelPi", "_Z5plainPi"]
    ins = funcs["_Z6kernelPi"]
    assert len(ins) == 14
    assert ins[5] == (0x50, "@P0", "BRA", "0x80")
    assert ins[3][2] == "LDS.U16"


@pytest.mark.parametrize("op,want", [
    ("IMAD.WIDE.U32", "fma"), ("IMAD.MOV.U32", "fma"), ("IADD3", "alu"),
    ("VIMNMX.RELU", "alu"), ("PRMT", "alu"), ("LDS.128", "shared"),
    ("LDGSTS.E.BYPASS.128", "shared"), ("STG.E.128", "global"),
    ("BAR.SYNC.DEFER_BLOCKING", "other"), ("ULDC", "other"),
])
def test_classify_bins_by_unit(op, want):
    assert sc.classify(op) == want


def test_main_loop_is_the_longest_backward_branch_and_paths_fork():
    ins = sc.parse(LISTING)["_Z6kernelPi"]
    head, tail = sc.main_loop(ins)
    assert (ins[head][0], ins[tail][0]) == (0x20, 0xb0)  # not the BRA to itself
    ps = sc.paths(ins, head, tail)
    assert sorted(p["total"] for p in ps) == [8, 10]
    short = min(ps, key=lambda p: p["total"])
    assert (short["fma"], short["alu"], short["shared"], short["global"]) == (2, 1, 1, 1)
    long = max(ps, key=lambda p: p["total"])
    assert long["alu"] == 3


def test_report_counts_a_loopless_kernel_to_its_exit_and_lists_calls(capsys):
    got = sc.report("_Z5plainPi", sc.parse(LISTING)["_Z5plainPi"])
    assert got["shortest"]["total"] == 4 and got["calls"] == ["0x100"]
    assert "no loop" in capsys.readouterr().out


def test_main_reads_a_listing_from_a_file(tmp_path, capsys):
    path = tmp_path / "lib.sass"
    path.write_text(LISTING)
    assert sc.main([str(path), "kernel"]) == 0
    out = capsys.readouterr().out
    assert "_Z6kernelPi" in out and "_Z5plainPi" not in out
    assert sc.main([]) == 2


@pytest.mark.parametrize("name", ["kernel_lab", "int_pipes", "e2e_rates"])
def test_card_tools_import_without_a_card(name):
    """The measurement scripts lie beside the package, outside of what is
    installed (mjpeg423_tpu_torch/scripts/ is no package), and run as files."""
    path = pathlib.Path(sc.__file__).parents[1] / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_port_script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main)
    assert not (path.parent / "__init__.py").exists()
