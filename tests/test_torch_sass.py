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
    assert ab._kernel_part("ec_comb_general_secp256k1_strict") == (
        "comb_general_strict_secp256k1_kernel")
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


# ptxas -v on a kernel that calls two device functions (P-521's fe_mul and
# fe_sqr, __noinline__): their property lines follow the kernel's (as CUDA
# 12.8's ptxas prints them), or come first
PTXAS_CALLS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118comb_p521_kernelEPKiPKhS1_PiS4_S4_l' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118comb_p521_kernelEPKiPKhS1_PiS4_S4_l
    152 bytes stack frame, 152 bytes spill stores, 152 bytes spill loads
ptxas info    : Used 255 registers, 54272 bytes smem, 400 bytes cmem[0]
ptxas info    : Compile time = 3808.190 ms
ptxas info    : Function properties for _ZN4p521L6fe_mulEN2ec4fe_tILi17EEES2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _ZN4p521L6fe_sqrEN2ec4fe_tILi17EEE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120ladder_p521_kernelEPKiS1_S1_PiS2_S2_l' for 'sm_90a'
ptxas info    : Function properties for _ZN4p521L6fe_sqrEN2ec4fe_tILi17EEE
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _ZN12_GLOBAL__N_120ladder_p521_kernelEPKiS1_S1_PiS2_S2_l
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, 392 bytes cmem[0]
"""


def test_ptxas_gives_a_callee_its_own_properties():
    """A called function's stack frame and spill line stays its own: the
    wide kernel B keeps its 152 spill bytes (the parser gave it the last
    callee's 0 before), a kernel whose callee's lines come first keeps its
    own 0, and the callees appear under their own names, with no
    registers."""
    rep = sass.ptxas(PTXAS_CALLS)
    comb = sass.resources(rep, "comb_p521_kernel")
    assert comb == {"stack_frame_bytes": 152, "spill_stores": 152, "spill_loads": 152,
                    "registers": 255, "smem_bytes": 54272}
    lad = sass.resources(rep, "ladder_p521_kernel")
    assert lad == {"stack_frame_bytes": 0, "spill_stores": 0, "spill_loads": 0,
                   "registers": 255, "smem_bytes": 0}
    mul = rep["_ZN4p521L6fe_mulEN2ec4fe_tILi17EEES2_"]
    assert mul == {"stack_frame_bytes": 0, "spill_stores": 0, "spill_loads": 0}
    assert rep["_ZN4p521L6fe_sqrEN2ec4fe_tILi17EEE"]["stack_frame_bytes"] == 8


LADDER = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_118ladder_p256_kernelEPKiS1_S1_PiS2_S2_l
        /*0000*/                   LDG.E R2, desc[UR4][R4.64] ;
        /*0010*/                   LDG.E R3, desc[UR4][R6.64] ;
        /*0020*/                   SHF.R.U32.HI R8, RZ, R9, R2 ;
        /*0030*/                   IMAD.WIDE.U32 R10, R12, R13, R10 ;
        /*0040*/                   STL [R1], R10 ;
        /*0050*/               @P0 BRA 0x20 ;
        /*0060*/               @P1 BRA 0x10 ;
        /*0070*/                   STG.E desc[UR4][R4.64], R10 ;
        /*0080*/                   EXIT ;
"""


def test_kernels_a_and_d_are_read():
    """Kernels A and D are read by default on their five curves. A's loop
    nest is the scalar's words, then their bits (254 ZDAU steps over 8
    words on P-256, 526 over 17 on P-521): on a listing of that shape the
    spill store inside the bit loop runs 254 times a lane. D's loops are
    its inversion chain's squarings, which sum to the chain's squarings
    less those made outside a loop, with the walks over a thread's lanes or
    the block's warps that are loops."""
    for tag in ("p256", "secp256k1", "w25519", "p384", "p521"):
        assert f"ladder_{tag}_kernel" in sass.DEFAULT_KERNELS
        assert f"affine_{tag}_kernel" in sass.DEFAULT_KERNELS
    assert sass.TRIPS["ladder_p521_kernel"] == [("word", 17, [("bit", sass.Fraction(526, 17),
                                                                 [])])]
    instrs = sass.parse(LADDER)["_ZN12_GLOBAL__N_118ladder_p256_kernelEPKiS1_S1_PiS2_S2_l"]
    tree = sass.loops(instrs)
    per_lane = sass.dynamic(instrs, tree, sass.TRIPS["ladder_p256_kernel"])
    # outside: LDG, STG, EXIT; the word loop's own LDG and BRA 8 times; the
    # bit loop's 4 instructions 254 times
    assert per_lane["stl"] == 254 and per_lane["ldg"] == 1 + 8
    assert per_lane["total"] == 3 + 2 * 8 + 4 * 254
    squarings = {tag: sum(n if isinstance(n, int) else n[1] for n in loops)
                 for tag, loops in sass._INV_SQUARINGS.items()}
    assert squarings == {"p256": 253, "secp256k1": 253, "w25519": 252, "p384": 383,
                         "p521": 522}
    assert sass.TRIPS["affine_p521_kernel"][4] == ("k", 6, [("sqr", 84, [])])
    # P-521's block tree: the warps' walks around the chain; P-256: the walk
    # back over a thread's 16 lanes after it, four lanes a trip
    assert sass.TRIPS["affine_p521_kernel"][0] == ("warps", 3, [])
    assert sass.TRIPS["affine_p256_kernel"][-1] == ("back", 3, [])


def test_report_tells_kernel_a_from_the_x_only_ladder(monkeypatch, tmp_path):
    """report() picks ``ladder_w25519_kernel`` and not the x-only ladder's
    ``mladder_w25519_kernel``, whose mangled name holds it and may be the
    shorter one."""
    listing = """
	code for sm_90a
		Function : _ZN8_GLOBAL__N_121mladder_w25519_kernelEPKiS1_PiS2_l
        /*0000*/                   EXIT ;
		Function : _ZN47_GLOBAL__N__71e37721_14_ladder_cu_c5c0ba0820ladder_w25519_kernelEPKiS1_S1_PiS2_S2_l
        /*0000*/                   IMAD.WIDE.U32 R2, R4, R5, R2 ;
        /*0010*/                   EXIT ;
"""

    class Done:
        stdout = listing

    monkeypatch.setattr(sass.subprocess, "run", lambda *a, **k: Done())
    monkeypatch.setattr(sass, "cuobjdump", lambda: "cuobjdump")
    rep = sass.report(tmp_path / "lib.so", ["ladder_w25519_kernel", "mladder_w25519_kernel"])
    assert "20ladder_w25519_kernel" in rep["ladder_w25519_kernel"]["function"]
    assert rep["ladder_w25519_kernel"]["static"]["imad"] == 1
    assert "mladder" in rep["mladder_w25519_kernel"]["function"]


def _listing(name, body):
    """A cuobjdump listing of one kernel from (opcode and operands) lines,
    16 bytes apart."""
    lines = [f"        /*{16 * i:04x}*/                   {op} ;" for i, op in enumerate(body)]
    return "\n\tcode for sm_90a\n\t\tFunction : " + name + "\n" + "\n".join(lines) + "\n"


def test_kernels_j_and_k_are_read():
    """Kernels J and K are read by default on their five curves, with their
    loop nests: K's copies of positions 0, 1 and 2, then positions 1 ..
    npos - 1 each staging j + 2 (IMMA outside every loop but the position
    loop: the selection is unrolled); J's copies of steps 0 and 1, then
    steps 1 .. npos / 2 - 1 with the next step's two copies and the pending
    sums' loop (29 trips at 256 bits, a fold a step on P-384 / P-521). On a
    listing of K's shape an IMMA in the position loop runs npos - 1 times a
    lane; the parent's masked scan reads as TRIPS_SCAN."""
    for tag in ("p256", "secp256k1", "w25519", "p384", "p521"):
        for kind in ("tree", "pipe"):
            assert f"comb_{kind}_{tag}_kernel" in sass.DEFAULT_KERNELS
    pipe = sass.TRIPS["comb_pipe_p521_kernel"]
    assert [t[:2] for t in pipe] == [("stage0", 17), ("stage1", 9), ("stage2", 9),
                                     ("position", 65)]
    assert pipe[3][2] == [("stage", sass.Fraction(63 * 9, 65), [])]
    tree = sass.TRIPS["comb_tree_p256_kernel"]
    assert [t[:2] for t in tree] == [("stage0", 8), ("stage0_hi", 4), ("stage1_lo", 4),
                                     ("stage1_hi", 4), ("step", 15)]
    assert tree[4][2][2] == ("fold", sass.Fraction(29, 15), [])
    assert sass.TRIPS["comb_tree_p384_kernel"][4][2][2] == ("fold", 1, [])
    assert sass.TRIPS_SCAN["comb_pipe_p256_kernel"][2] == ("scan0", 64, [])
    assert sass.TRIPS_SCAN["comb_tree_p521_kernel"][2][2][5] == (
        "fold", sass.Fraction(32, 33), [])
    body = ["IMMA.16832.U8.U8 R4, R8, R12, R4", "BRA 0x0",  # stage0
            "LDSM.16.M88.4 R4, [R2]", "BRA 0x20",  # stage1
            "SHFL.IDX R3, R3, R4, 0x1f", "BRA 0x40",  # stage2
            "IMMA.16832.U8.U8 R4, R8, R12, R4",  # position
            "STS.U16 [R2], R4", "BRA 0x70",  # its stage loop
            "BRA 0x60", "EXIT"]
    name = "_ZN12_GLOBAL__N_121comb_pipe_p256_kernelEPKiPKhS1_PiS4_S4_l"
    instrs = sass.parse(_listing(name, body))[name]
    per_lane = sass.dynamic(instrs, sass.loops(instrs), sass.TRIPS["comb_pipe_p256_kernel"])
    assert per_lane["imma"] == 8 + 31 and per_lane["ldsm"] == 4 and per_lane["shfl"] == 4
    assert per_lane["sts"] == 29 * 4  # positions 3 .. 31 staged, 4 chunks a thread each


def test_block_tree_inversion_counts_one_threads_share():
    """Kernel D's block tree on P-384 / P-521: the code from its first loop
    (the warps' walk forward) to its last (the walk back), the inversion
    chain's straight-line multiplies between them included, counts 1 / 128
    of its runs in each thread; code before and after counts in full."""
    assert sass.ONE_THREAD == {"affine_p384_kernel": (0, -1, 128),
                               "affine_p521_kernel": (0, -1, 128)}
    body = ["IMAD R2, R3, R4, R5",  # every thread
            "IMAD R2, R3, R4, R5", "BRA 0x10",  # the warps' walk: 3 trips
            "IMAD R2, R3, R4, R5",  # the chain, straight-line
            "IMAD R2, R3, R4, R5", "BRA 0x40",  # a squaring loop: 128 trips
            "IMAD R2, R3, R4, R5", "BRA 0x60",  # the walk back: 3 trips
            "IMAD R2, R3, R4, R5", "EXIT"]  # every thread
    name = "_ZN12_GLOBAL__N_118affine_p384_kernelEPKiS1_S1_PiS2_l"
    instrs = sass.parse(_listing(name, body))[name]
    tree = sass.loops(instrs)
    trips = [("warps", 3, []), ("sqr", 128, []), ("warps_back", 3, [])]
    full = sass.dynamic(instrs, tree, trips)
    assert full["imad"] == 1 + 3 + 1 + 128 + 3 + 1
    share = sass.dynamic(instrs, tree, trips, (0, -1, 128))
    inside = 3 + 1 + 128 + 3  # the region's IMADs, counted in one thread of 128
    assert share["imad"] == round(2 + sass.Fraction(inside, 128))


def test_kernels_g_and_h_are_read():
    """Kernels G and H are read by default. G's loop nest is the scalar's 16
    digit words, then their bits (255 steps, the top word's 15): on a
    listing of that shape the word loop's load runs 16 times a lane and the
    bit loop's product 255 times; a library built before G read its digit
    word once per 16 steps has one loop of 255 steps (``TRIPS_G_BITS``).
    H's loops are its inversion chain's squarings, as kernel D's on
    Wei25519."""
    assert {"mladder_w25519_kernel", "xdivz_w25519_kernel"} <= set(sass.DEFAULT_KERNELS)
    assert sass.TRIPS["xdivz_w25519_kernel"] == [
        ("sqr", n, []) for n in sass._INV_SQUARINGS["w25519"]]
    body = ["LDG.E R4, desc[UR4][R2.64]",  # the word loop: its digit word
            "IMAD.WIDE.U32 R6, R8, R9, R6", "BRA 0x10",  # the bit loop
            "BRA 0x0", "STG.E desc[UR4][R2.64], R6", "EXIT"]
    name = "_ZN12_GLOBAL__N_121mladder_w25519_kernelEPKiS1_PiS2_l"
    instrs = sass.parse(_listing(name, body))[name]
    per_lane = sass.dynamic(instrs, sass.loops(instrs), sass.TRIPS["mladder_w25519_kernel"])
    assert per_lane["ldg"] == 16 and per_lane["imad"] == 255 and per_lane["stg"] == 1
    assert per_lane["control"] == 255 + 16 + 1
    old = ["LDG.E R4, desc[UR4][R2.64]", "IMAD.WIDE.U32 R6, R8, R9, R6", "BRA 0x0", "EXIT"]
    instrs = sass.parse(_listing(name, old))[name]
    tree = sass.loops(instrs)
    assert sass.dynamic(instrs, tree, sass.TRIPS["mladder_w25519_kernel"]) is None
    assert sass.dynamic(instrs, tree, sass.TRIPS_G_BITS["mladder_w25519_kernel"])["ldg"] == 255
