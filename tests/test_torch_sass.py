"""The SASS and ptxas readers of ecsimd_tpu_torch/bench/sass.py and the
kernel-name mapping of bench/ab.py, on made-up cuobjdump and ptxas output
(the tools themselves need the CUDA toolkit)."""

from ecsimd_tpu_torch.bench import ab, sass

LISTING = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_118window_p256_kernelEPKiS1_S1_PiS2_S2_l
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
                                                              /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   IMAD.WIDE.U32 R2, R4, R5, R2 ;
        /*0030*/                   IADD3.X R6, RZ, R6, RZ, P0, !PT ;
        /*0040*/                   IMAD.MOV.U32 R7, RZ, RZ, R6 ;
        /*0050*/                   STL [R1], R7 ;
        /*0060*/              @!P0 BRA 0x20 ;
        /*0070*/                   LDS.128 R8, [R3] ;
        /*0080*/                   LDS R12, [R3+0x10] ;
        /*0090*/               @P1 BRA 0x70 ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   BRA 0xb0;
		Function : _ZN12_GLOBAL__N_126glv_strict_secp256k1_kernelEPKiS1_
        /*0000*/                   EXIT ;
"""


def test_classify():
    assert sass.classify("IMAD.WIDE.U32") == "imad"
    assert sass.classify("IMAD.HI.U32") == "imad"
    assert sass.classify("IMAD.MOV.U32") == "imad_move"
    assert sass.classify("IADD3.X") == "alu"
    assert sass.classify("LOP3.LUT") == "alu"
    assert sass.classify("LDS.128") == "lds128"
    assert sass.classify("LDL.64") == "ldl"
    assert sass.classify("ULDC.64") == "uniform"
    assert sass.classify("BRA") == "control"


def test_parse_loops_and_per_lane_counts():
    funcs = sass.parse(LISTING)
    assert sorted(funcs) == ["_ZN12_GLOBAL__N_118window_p256_kernelEPKiS1_S1_PiS2_S2_l",
                             "_ZN12_GLOBAL__N_126glv_strict_secp256k1_kernelEPKiS1_"]
    instrs = funcs["_ZN12_GLOBAL__N_118window_p256_kernelEPKiS1_S1_PiS2_S2_l"]
    assert len(instrs) == 12
    tree = sass.loops(instrs)
    assert [(n["start"], n["end"]) for n in tree] == [(0x20, 0x60), (0x70, 0x90)]
    assert tree[0]["mix"] == {"imad": 1, "alu": 1, "imad_move": 1, "stl": 1, "control": 1,
                              "total": 5}
    assert tree[1]["mix"] == {"lds128": 1, "lds": 2, "control": 1, "total": 3}
    per_lane = sass.dynamic(instrs, tree, [("a", 3, []), ("b", 2, [])])
    # outside the loops: LDC, S2R, EXIT, BRA; then 3 x 5 and 2 x 3
    assert per_lane["total"] == 4 + 15 + 6
    assert per_lane["imad"] == 3 and per_lane["stl"] == 3 and per_lane["lds"] == 4
    assert sass.dynamic(instrs, tree, [("a", 3, [("inner", 2, [])])]) is None


def test_ab_kernel_names():
    assert ab._kernel_part("ec_window_p256") == "window_p256_kernel"
    assert ab._kernel_part("ec_window_p256_strict") == "window_strict_p256_kernel"
    assert ab._kernel_part("ec_glv_secp256k1_strict") == "glv_strict_secp256k1_kernel"
    assert ab._kernel_part("ec_comb_chains_p256_c1u4_strict") == (
        "comb_chains_p256_kernelILi1ELi4ELb1E")
    assert ab._kernel_part("ec_comb_chains_secp256k1_c2u1") == (
        "comb_chains_secp256k1_kernelILi2ELi1ELb0E")
    assert ab._kernel_part("ec_window_w25519_strict") == "window_strict_w25519_kernel"
    assert ab._kernel_part("ec_comb_w25519_strict") == "comb_strict_w25519_kernel"
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118window_p256_kernelEv' "
           "for 'sm_90a'\nptxas info    : Function properties for _ZN12_GLOBAL__N_118window_"
           "p256_kernelEv\n    320 bytes stack frame, 160 bytes spill stores, 160 bytes spill "
           "loads\nptxas info    : Used 255 registers, 49152 bytes smem, 400 bytes cmem[0]\n")
    rep = sass.ptxas(log)
    assert sass.resources(rep, "window_p256_kernel") == {
        "stack_frame_bytes": 320, "spill_stores": 160, "spill_loads": 160, "registers": 255,
        "smem_bytes": 49152}
    assert sass.resources(rep, "glv_secp256k1_kernel") is None
    # a name inside a longer one: the x-only ladder's kernel is not kernel A's
    two = sass.ptxas(
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121mladder_w25519_kernelEv' "
        "for 'sm_90a'\nptxas info    : Used 96 registers, 0 bytes smem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120ladder_w25519_kernelEPKiS1_S1_"
        "PiS2_S2_l' for 'sm_90a'\nptxas info    : Used 168 registers, 0 bytes smem\n")
    assert sass.resources(two, "ladder_w25519_kernel")["registers"] == 168
    assert sass.resources(two, "mladder_w25519_kernel")["registers"] == 96


CALLS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_118window_p521_kernelEPKiS1_S1_PiS2_S2_Pill
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   CALL.REL.NOINC 0x90 ;
        /*0020*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0030*/                   CALL.REL.NOINC 0xc0 ;
        /*0040*/                   CALL.REL.NOINC 0x90 ;
        /*0050*/               @P0 BRA 0x20 ;
        /*0060*/                   LDG.E.CONSTANT R8, desc[UR4][R6.64] ;
        /*0070*/                   EXIT ;
        /*0080*/                   BRA 0x80;
        /*0090*/                   IMAD.WIDE.U32 R2, R4, R5, R2 ;
        /*00a0*/                   IMAD.WIDE.U32 R2, R4, R5, R2 ;
        /*00b0*/                   RET.REL.NODEC R20 0x0 ;
        /*00c0*/                   IMAD.WIDE.U32 R2, R4, R4, R2 ;
        /*00d0*/                   RET.REL.NODEC R20 0x0 ;
"""


def test_callees_enter_the_per_lane_count():
    """A kernel's called device functions (after its EXIT, each from a CALL
    target to its RET) stay out of its own code and loops, are counted
    once each, and enter the dynamic count once a call; a loop's trips may
    be a fraction whose runs are whole (P-521's 132 windows over 17
    words)."""
    instrs = sass.parse(CALLS)["_ZN12_GLOBAL__N_118window_p521_kernelEPKiS1_S1_PiS2_S2_Pill"]
    called = sass.callees(instrs)
    assert sorted(called) == [0x90, 0xc0]
    assert [x[0] for x in called[0x90]] == [0x90, 0xa0, 0xb0]
    assert [x[0] for x in called[0xc0]] == [0xc0, 0xd0]
    mine = sass.own(instrs)
    assert [x[0] for x in mine] == [0x0, 0x10, 0x20, 0x30, 0x40, 0x50, 0x60, 0x70, 0x80]
    tree = sass.loops(mine)
    assert [(n["start"], n["end"]) for n in tree] == [(0x20, 0x50)]
    per_lane = sass.dynamic(instrs, tree, [("loop", sass.Fraction(6, 2), [])])
    # own: 5 outside the loop (S2R, CALL, LDG.CONSTANT, EXIT, BRA) + 3 x 4;
    # calls: 0x90 once outside and 3 times inside (3 instructions each),
    # 0xc0 3 times (2 each)
    assert per_lane["total"] == 5 + 12 + 4 * 3 + 3 * 2
    assert per_lane["imad"] == 4 * 2 + 3 * 1
    assert per_lane["ldg128"] == 3 and per_lane["ldg_nc"] == 1 and per_lane["ldg"] == 4
    rep = sass.TRIPS["window_p521_kernel"]
    assert rep[0][0] == "lane" and rep[0][2][1][2][0][1] * 17 == 132


SELECT = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_116comb_p256_kernelEPKiPKhS1_PiS4_S4_l
        /*0000*/                   SHFL.IDX PT, R3, R2, R0, 0x1f ;
        /*0010*/                   LDSM.16.M88.4 R4, [R9] ;
        /*0020*/                   IMMA.16832.U8.U8 R12, R16.ROW, R4.COL, RZ ;
        /*0030*/                   IMMA.16832.U8.U8 R12, R20.ROW, R6.COL, R12 ;
        /*0040*/                   STS.U16 [R10], R12 ;
        /*0050*/                   WARPSYNC.ALL ;
        /*0060*/                   LDS.64 R24, [R11] ;
        /*0070*/                   EXIT ;
"""


def test_tensor_core_select_classes():
    """The instructions of the comb's table read on the tensor cores
    (csrc/comb_mma.cuh) on a captured snippet: IMMA in its own class, the
    ldmatrix loads (LDSM) and the 8-byte row-buffer reads among the shared
    loads, the shuffles in theirs; kernels B and the generic L are read by
    default on their five curves, plain and strict."""
    assert sass.classify("IMMA.16832.U8.U8") == "imma"
    assert sass.classify("LDSM.16.M88.4") == "ldsm"
    assert sass.classify("SHFL.IDX") == "shfl"
    mix = sass._mix(sass.parse(SELECT)["_ZN12_GLOBAL__N_116comb_p256_kernelEPKiPKhS1_PiS4_S4_l"])
    assert mix == {"shfl": 1, "ldsm": 1, "lds": 2, "imma": 2, "sts": 1, "control": 2,
                   "total": 8}
    for tag in ("p256", "secp256k1", "w25519", "p384", "p521"):
        for st in ("", "_strict"):
            assert f"comb{st}_{tag}_kernel" in sass.DEFAULT_KERNELS
            assert f"comb_general{st}_{tag}_kernel" in sass.DEFAULT_KERNELS
    # the per-lane loop nests: kernel B's positions 1 .. npos - 1 (position 0
    # before the loop), and the parent's masked scan for an older library
    assert sass.TRIPS["comb_p521_kernel"][2][:2] == ("position", 65)
    assert sass.TRIPS_SCAN["comb_p256_kernel"][1][2][1] == ("scan0", 2, [])
