// vmloop_core.h — one REXAVM node's fetch/decode/execute loop, written once
// for two compilers: nvcc builds it into the CUDA kernel (vmloop.cu) and g++
// builds it into a CPU library for the semantics test
// (tests/test_torch_vmloop.py, csrc/vmloop_host.cpp).
//
// Every op body transliterates the batched PyTorch interpreter
// (repro_torch/core/vm/interp.py), which in turn is held bit for bit
// against the JAX reference (repro/core/vm/interp.py).  The rules that keep
// it bit-exact:
//   * int32 arithmetic that may overflow (+ - * negate abs) goes through
//     uint32 (w* helpers): signed overflow is undefined in C++, and the
//     reference wraps;
//   * `/` and `//` of the reference are floor divisions (fdiv); `/` and
//     `mod` of the VM are the reference's truncdiv/truncmod built on them,
//     so INT_MIN / 3 == 715827883, as in the reference;
//   * every array index is clamped into its array, and every write the
//     reference drops is skipped, so no access leaves the node's row;
//   * vector writes go element by element in ascending order, so where a
//     clamped index repeats the last write wins, as in the reference.

#pragma once
#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define RX_HD __host__ __device__ __forceinline__
#else
#define RX_HD inline
#endif

#ifdef __CUDA_ARCH__
#define RX_LDG(p) __ldg(p)      // constant LUTs through the read-only path
#define RX_UNROLL4 _Pragma("unroll 4")   // a vector loop's loads issued together
#else
#define RX_LDG(p) (*(p))
#define RX_UNROLL4
#endif

namespace rexavm {

// Opcodes in ISA word order (repro_torch/core/vm/spec.py WORDS); a test
// checks this list against the ISA.
enum Op : int32_t {
    OP_NOP = 0,          // nop
    OP_DUP = 1,          // dup
    OP_DROP = 2,         // drop
    OP_SWAP = 3,         // swap
    OP_OVER = 4,         // over
    OP_ROT = 5,          // rot
    OP_NIP = 6,          // nip
    OP_TUCK = 7,         // tuck
    OP_PICK = 8,         // pick
    OP_TWODUP = 9,       // 2dup
    OP_TWODROP = 10,      // 2drop
    OP_DEPTH = 11,        // depth
    OP_ADD = 12,          // +
    OP_SUB = 13,          // -
    OP_MUL = 14,          // *
    OP_DIV = 15,          // /
    OP_MOD = 16,          // mod
    OP_MULDIV = 17,       // */
    OP_NEGATE = 18,       // negate
    OP_ABS = 19,          // abs
    OP_MIN = 20,          // min
    OP_MAX = 21,          // max
    OP_INC = 22,          // 1+
    OP_DEC = 23,          // 1-
    OP_TWOMUL = 24,       // 2*
    OP_TWODIV = 25,       // 2/
    OP_EQ = 26,           // =
    OP_NE = 27,           // <>
    OP_LT = 28,           // <
    OP_GT = 29,           // >
    OP_LE = 30,           // <=
    OP_GE = 31,           // >=
    OP_ZEQ = 32,          // 0=
    OP_ZLT = 33,          // 0<
    OP_ZGT = 34,          // 0>
    OP_AND = 35,          // and
    OP_OR = 36,           // or
    OP_XOR = 37,          // xor
    OP_INVERT = 38,       // invert
    OP_LSHIFT = 39,       // lshift
    OP_RSHIFT = 40,       // rshift
    OP_FETCH = 41,        // @
    OP_STORE = 42,        // !
    OP_ADDSTORE = 43,     // +!
    OP_GET = 44,          // get
    OP_PUT = 45,          // put
    OP_PUSH = 46,         // push
    OP_POP = 47,          // pop
    OP_FILL = 48,         // fill
    OP_LEN = 49,          // len
    OP_BRANCH = 50,       // branch
    OP_ZBRANCH = 51,      // 0branch
    OP_RET = 52,          // ret
    OP_EXIT = 53,         // exit
    OP_EXEC = 54,         // exec
    OP_DOINIT = 55,       // doinit
    OP_DOLOOP = 56,       // doloop
    OP_I = 57,            // i
    OP_J = 58,            // j
    OP_UNLOOP = 59,       // unloop
    OP_HALT = 60,         // halt
    OP_END = 61,          // end
    OP_DLIT = 62,         // dlit
    OP_PRINT = 63,        // .
    OP_EMIT = 64,         // emit
    OP_CR = 65,           // cr
    OP_PRSTR = 66,        // prstr
    OP_VECPRINT = 67,     // vecprint
    OP_OUT = 68,          // out
    OP_IN = 69,           // in
    OP_SEND = 70,         // send
    OP_RECEIVE = 71,      // receive
    OP_YIELD = 72,        // yield
    OP_SLEEP = 73,        // sleep
    OP_AWAIT = 74,        // await
    OP_TASK = 75,         // task
    OP_TASKID = 76,       // taskid
    OP_MS = 77,           // ms
    OP_STEPS = 78,        // steps
    OP_EXCEPTION = 79,    // exception
    OP_CATCH = 80,        // catch
    OP_THROW = 81,        // throw
    OP_SIN = 82,          // sin
    OP_LOG = 83,          // log
    OP_SIGMOID = 84,      // sigmoid
    OP_RELU = 85,         // relu
    OP_SQRT = 86,         // sqrt
    OP_RND = 87,          // rnd
    OP_VECLOAD = 88,      // vecload
    OP_VECSCALE = 89,     // vecscale
    OP_VECADD = 90,       // vecadd
    OP_VECMUL = 91,       // vecmul
    OP_VECFOLD = 92,      // vecfold
    OP_VECMAP = 93,       // vecmap
    OP_DOTPROD = 94,      // dotprod
    OP_VECMAX = 95,       // vecmax
    OP_HULL = 96,         // hull
    OP_LOWP = 97,         // lowp
    OP_HIGHP = 98,        // highp
    NUM_OPS = 99
};

constexpr int32_t MEM_BASE = 1 << 20;
constexpr int32_t NUM_EXC = 9;
constexpr int32_t MAX_VEC = 64;      // largest VMConfig.max_vec the kernel takes
constexpr int32_t MAXSTR = 64;
constexpr int32_t OUT_NUM = 0, OUT_CHR = 1;
constexpr int32_t EXC_TRAP = 1, EXC_STACK = 2, EXC_DIVBYZERO = 6, EXC_BOUNDS = 7;
constexpr int32_t ST_RUN = 0, ST_DONE = 1, ST_HALT = 2, ST_ERR = 3, ST_IOWAIT = 4,
                  ST_SLEEP = 5, ST_EVENT = 6, ST_YIELD = 7, ST_FREE = 8;
constexpr int32_t I32_MIN = (int32_t)0x80000000u;
// Retirement bins of the counting instance (repro_torch/obs/metrics.py):
// the opcodes, then fios/trap (= NUM_OPS), literal, call, invalid.
constexpr int32_t NUM_BINS = NUM_OPS + 4;

// Sizes of one VMConfig.
struct Dims {
    int32_t CS, MEM, T, DS, RS, FS, OUTN, MV;
};

// Base pointers of the 24 CoreState fields of a node-strided stacked state
// (field order of ref.CORE_FIELDS).  The kernel updates them in place.
struct Fields {
    int32_t *cs, *mem, *ds, *rs, *fs;
    int32_t *dsp, *rsp, *fsp, *pc, *tstatus;
    int32_t *timeout, *ev_addr, *ev_val;
    int32_t *catch_pc, *catch_rsp, *pending_exc, *last_exc;
    int32_t *io_op, *handlers, *cur, *now, *steps;
    int32_t *out, *outp;
};

// Constant tables (ref.Tables order).
struct Tabs {
    const int32_t *sup, *din, *dout, *fin, *fout, *log10, *sg13, *sg310, *sinq;
};

// The four value LUTs, passed by value to the out-of-line words.
struct Luts {
    const int32_t *log10, *sg13, *sg310, *sinq;
};

// One opcode's claim bit and stack effect, packed into one word by the
// wrapper (vmloop.py pack_meta): bit 0 claimed, then din, dout, fin, fout in
// 7-bit fields.
RX_HD int32_t meta_din(int32_t m) { return (m >> 1) & 127; }
RX_HD int32_t meta_dout(int32_t m) { return (m >> 8) & 127; }
RX_HD int32_t meta_fin(int32_t m) { return (m >> 15) & 127; }
RX_HD int32_t meta_fout(int32_t m) { return (m >> 22) & 127; }

// -- integer helpers --------------------------------------------------------

RX_HD int32_t wadd(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
RX_HD int32_t wsub(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }
RX_HD int32_t wmul(int32_t a, int32_t b) { return (int32_t)((uint32_t)a * (uint32_t)b); }
// Negation and abs that wrap at INT_MIN (-INT_MIN == abs(INT_MIN) ==
// INT_MIN, as in jnp).  On the device the negation is an opaque PTX `sub`:
// nvcc recognised `a < 0 ? -a : a` as an abs whose result is never
// negative and dropped the INT_MIN branch of a later floor division
// (INT_MIN / 3 came out 715827882), however the negation was spelt.
RX_HD int32_t wneg(int32_t a) {
#ifdef __CUDA_ARCH__
    int32_t r;
    asm("sub.s32 %0, 0, %1;" : "=r"(r) : "r"(a));
    return r;
#else
    return (int32_t)(0u - (uint32_t)a);
#endif
}
RX_HD int32_t wabs(int32_t a) { return a < 0 ? wneg(a) : a; }
RX_HD int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }
RX_HD int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }
RX_HD int32_t clampi(int32_t x, int32_t lo, int32_t hi) { return imin(imax(x, lo), hi); }
RX_HD int32_t sgn(int32_t a) { return (a > 0) - (a < 0); }

// Floor division (numpy/jnp `//`).  b != 0.
RX_HD int32_t fdiv(int32_t a, int32_t b) {
    if (b == -1) return wneg(a);
    int32_t q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
    return q;
}

// Floor modulo by a positive m.
RX_HD int32_t fmodp(int32_t a, int32_t m) {
    int32_t r = a % m;
    return r < 0 ? r + m : r;
}

RX_HD int32_t truncdiv(int32_t a, int32_t b) {
    int32_t q = fdiv(wabs(a), imax(wabs(b), 1));
    return ((a < 0) != (b < 0)) ? wneg(q) : q;
}

RX_HD int32_t truncmod(int32_t a, int32_t b) { return wsub(a, wmul(truncdiv(a, b), b)); }

// a*b/c with a 64-bit intermediate: the low 32 bits of floor(|a||b|/C),
// C = max(abs(c), 1) in signed int32 (c = INT_MIN gives C = 1).
RX_HD int32_t muldiv(int32_t a, int32_t b, int32_t c) {
    bool neg = ((a < 0) != (b < 0)) != (c < 0);
    uint64_t A = (uint32_t)wabs(a), B = (uint32_t)wabs(b);
    uint64_t C = (uint32_t)imax(wabs(c), 1);
    int32_t q = (int32_t)(uint32_t)((A * B) / C);
    return neg ? wneg(q) : q;
}

// -- fixed-point LUT scalars (repro_torch/core/fixedpoint/luts.py) ------------

RX_HD int32_t fplog10(int32_t x, const Luts& lt) {
    x = imax(x, 10);
    int32_t shift = 0;
    for (int k = 0; k < 3; ++k) {
        if (x >= 100) { shift += 1; x = fdiv(x, 10); }
    }
    return shift * 100 + RX_LDG(lt.log10 + clampi(x - 10, 0, 89));
}

RX_HD int32_t fpsigmoid(int32_t x, const Luts& lt) {
    bool mirror = x < 0;
    int32_t ax = wabs(x);
    int32_t y1 = wadd(500, fdiv(wmul(ax, 231), 1000));
    int32_t i13 = clampi(fdiv(fplog10(fdiv(ax, 5), lt), 2) - 65, 0, 23);
    int32_t y2 = RX_LDG(lt.sg13 + i13) + 731;
    int32_t i310 = clampi(fdiv(fplog10(fdiv(ax, 10), lt), 10) - 14, 0, 5);
    int32_t y3 = RX_LDG(lt.sg310 + i310) + 952;
    int32_t y = ax <= 1000 ? y1 : (ax < 3000 ? y2 : y3);
    if (ax >= 10000) y = 1000;
    return mirror ? wsub(1000, y) : y;
}

RX_HD int32_t fpsin(int32_t x, const Luts& lt) {
    x = fmodp(x, 6283);
    int32_t t = fdiv(x * 1024, 6283);
    int32_t quad = fdiv(t, 256);
    int32_t idx = fmodp(t, 256);
    int32_t mag = fmodp(quad, 2) == 0 ? RX_LDG(lt.sinq + idx) : RX_LDG(lt.sinq + 255 - idx);
    return quad >= 2 ? -mag : mag;
}

RX_HD int32_t fpsqrt(int32_t x) {
    x = imax(x, 0);
    int32_t r = (int32_t)sqrtf((float)x);
    r = clampi(r, 1, 46340);
    if (fdiv(x, r + 1) >= r + 1) r += 1;
    if (fdiv(x, r) < r) r -= 1;
    return x == 0 ? 0 : imax(r, 0);
}

RX_HD int32_t vscale1(int32_t v, int32_t s) {
    if (s > 0) return wmul(v, s);
    if (s < 0) return wmul(sgn(v), fdiv(wabs(v), wneg(s)));
    return v;
}

// -- one node's address space: its cs and mem rows --------------------------

// The row an address falls in (cs below MEM_BASE, mem from it), with the
// row's first address and last index: ld/st clamp an address into it.
struct Seg {
    int32_t* c;
    int32_t base, last;

    RX_HD int32_t ld(int32_t a) const { return c[clampi(wsub(a, base), 0, last)]; }
    RX_HD void st(int32_t a, int32_t v) const { c[clampi(wsub(a, base), 0, last)] = v; }
};

struct Space {
    int32_t *cs, *mem;
    int32_t CS, MEM, MV;

    // The row of address a; a vector from a stays in that row throughout.
    RX_HD Seg seg(int32_t a) const {
        return a >= MEM_BASE ? Seg{mem, MEM_BASE, MEM - 1} : Seg{cs, 0, CS - 1};
    }

    RX_HD int32_t cs_at(int32_t a) const { return cs[clampi(a, 0, CS - 1)]; }
    RX_HD int32_t mem_at(int32_t a) const { return mem[clampi(wsub(a, MEM_BASE), 0, MEM - 1)]; }
    RX_HD bool valid(int32_t a) const {
        return (a >= 0 && a < CS) || (a >= MEM_BASE && a < MEM_BASE + MEM);
    }
    RX_HD int32_t read(int32_t a) const { return a >= MEM_BASE ? mem_at(a) : cs_at(a); }
    RX_HD void write(int32_t a, int32_t v) const {
        if (a >= MEM_BASE) mem[clampi(wsub(a, MEM_BASE), 0, MEM - 1)] = v;
        else cs[clampi(a, 0, CS - 1)] = v;
    }
    // the ln cells from a, ln clamped to [0, window]; returns ln
    RX_HD int32_t vread(int32_t a, int32_t window, int32_t ln, int32_t* v) const {
        ln = clampi(ln, 0, window);
        const Seg s = seg(a);
        RX_UNROLL4
        for (int32_t k = 0; k < ln; ++k) v[k] = s.ld(wadd(a, k));
        return ln;
    }
    RX_HD int32_t vread_hdr(int32_t a, int32_t* v) const {
        return vread(a, MV, read(wsub(a, 1)), v);
    }
    RX_HD int32_t hdr(int32_t a) const { return clampi(read(wsub(a, 1)), 0, MV); }
    RX_HD void vwrite(int32_t a, const int32_t* v, int32_t ln) const {
        const Seg s = seg(a);
        for (int32_t k = 0; k < ln; ++k) s.st(wadd(a, k), v[k]);
    }
    // scale vector at saddr (0 = off); `s` is scratch of MAX_VEC cells
    RX_HD void apply_scalevec(int32_t* v, int32_t ln, int32_t saddr, int32_t* s) const {
        if (saddr == 0) return;
        vread(saddr, MV, ln, s);
        for (int32_t k = 0; k < ln; ++k) v[k] = vscale1(v[k], s[k]);
    }
};

RX_HD void iir_lowpass(const int32_t* x, int32_t ln, int32_t k, int32_t* y) {
    int32_t yy = ln > 0 ? x[0] : 0;
    for (int32_t i = 0; i < ln; ++i) {
        yy = wadd(yy, truncdiv(wmul(k, wsub(x[i], yy)), 1000));
        y[i] = yy;
    }
}

// -- the long words --------------------------------------------------------------

// sin / log / sigmoid / sqrt of x.
RX_HD int32_t dsp_word(int32_t code, int32_t x, Luts lt) {
    switch (code) {
    case OP_SIN: return fpsin(x, lt);
    case OP_LOG: return fplog10(x, lt) * 10;
    case OP_SIGMOID: return fpsigmoid(x, lt);
    default: return fpsqrt(x);
    }
}

// The vector words that write memory, on their popped arguments a0..a3
// (deepest first): fill vecload vecscale vecadd vecmul vecfold vecmap hull
// lowp highp.
RX_HD void vec_store_word(int32_t code, int32_t a0, int32_t a1, int32_t a2, int32_t a3,
                            Space sp, Luts lt) {
    int32_t v1[MAX_VEC], v2[MAX_VEC], v3[MAX_VEC];
    const int32_t MV = sp.MV;
    switch (code) {
    case OP_FILL: {                                   // v arr
        int32_t ln = sp.hdr(a1);
        for (int32_t k = 0; k < ln; ++k) v1[k] = a0;
        sp.vwrite(a1, v1, ln);
    } break;
    case OP_VECLOAD: {                                // src srcoff dst
        int32_t ln = sp.hdr(a2);
        sp.vread(wadd(a0, a1), MV, ln, v1);
        sp.vwrite(a2, v1, ln);
    } break;
    case OP_VECSCALE: {                               // src dst scalevec
        int32_t ln = sp.hdr(a1);
        sp.vread(a0, MV, ln, v1);
        sp.vread(a2, MV, ln, v2);
        for (int32_t k = 0; k < ln; ++k) v1[k] = vscale1(v1[k], v2[k]);
        sp.vwrite(a1, v1, ln);
    } break;
    case OP_VECADD:
    case OP_VECMUL: {                                 // a b dst scalevec
        int32_t ln = sp.hdr(a2);
        sp.vread(a0, MV, ln, v1);
        sp.vread(a1, MV, ln, v2);
        for (int32_t k = 0; k < ln; ++k)
            v1[k] = code == OP_VECADD ? wadd(v1[k], v2[k]) : wmul(v1[k], v2[k]);
        sp.apply_scalevec(v1, ln, a3, v3);
        sp.vwrite(a2, v1, ln);
    } break;
    case OP_VECFOLD: {                                // in wgt out scalevec
        int32_t n = sp.vread_hdr(a0, v1);
        int32_t m = sp.hdr(a2);
        const Seg w = sp.seg(a1);
        for (int32_t j = 0; j < m; ++j) {
            int32_t acc = 0;
            RX_UNROLL4
            for (int32_t i = 0; i < n; ++i) acc = wadd(acc, wmul(v1[i], w.ld(wadd(a1, i * m + j))));
            v2[j] = acc;
        }
        sp.apply_scalevec(v2, m, a3, v3);
        sp.vwrite(a2, v2, m);
    } break;
    case OP_VECMAP: {                                 // src dst fn scalevec
        int32_t ln = sp.hdr(a1);
        sp.vread(a0, MV, ln, v1);
        int32_t fn = clampi(a2, 0, 4);
        for (int32_t k = 0; k < ln; ++k) {
            int32_t x = v1[k];
            v1[k] = fn == 0 ? fpsigmoid(x, lt) : fn == 1 ? imax(x, 0)
                  : fn == 2 ? fpsin(x, lt) : fn == 3 ? fplog10(x, lt) * 10 : fpsqrt(x);
        }
        sp.apply_scalevec(v1, ln, a3, v3);
        sp.vwrite(a1, v1, ln);
    } break;
    default: {                                        // hull lowp highp: arr off len k
        int32_t base = wadd(a0, a1);
        int32_t hdr = sp.read(wsub(a0, 1));
        int32_t ln = clampi(imin(a2, wsub(hdr, a1)), 0, MV);
        sp.vread(base, MV, ln, v1);
        if (code == OP_HULL)
            for (int32_t k = 0; k < ln; ++k) v1[k] = wabs(v1[k]);
        iir_lowpass(v1, ln, a3, v2);
        if (code == OP_HIGHP)
            for (int32_t k = 0; k < ln; ++k) v2[k] = wsub(v1[k], v2[k]);
        sp.vwrite(base, v2, ln);
    } break;
    }
}

// dotprod (a0 a1) and vecmax (a0): the value pushed.  They only read, so
// they read the cells where they lie, with no scratch.
RX_HD int32_t vec_reduce_word(int32_t code, int32_t a0, int32_t a1, Space sp) {
    const int32_t n = sp.hdr(a0);
    const Seg x = sp.seg(a0);
    if (code == OP_DOTPROD) {
        const Seg y = sp.seg(a1);
        int32_t acc = 0;
        RX_UNROLL4
        for (int32_t k = 0; k < n; ++k)
            acc = wadd(acc, wmul(x.ld(wadd(a0, k)), y.ld(wadd(a1, k))));
        return acc;
    }
    int32_t best = 0, bv = I32_MIN;
    for (int32_t k = 0; k < n; ++k) {
        int32_t v = x.ld(wadd(a0, k));
        if (k == 0 || v > bv) { bv = v; best = k; }
    }
    return best;
}

// The output ring: `prstr` (ln cells of cs from p) and `vecprint` (the
// vector at addr).  Each returns the new ring position.
RX_HD int32_t prstr_word(int32_t p, int32_t ln, Space sp, int32_t* out, int32_t o, int32_t OUTN) {
    int32_t n = clampi(imin(ln, OUTN - o), 0, MAXSTR);
    for (int32_t k = 0; k < n; ++k) {
        out[2 * (o + k)] = OUT_CHR;
        out[2 * (o + k) + 1] = sp.cs_at(p + k);
    }
    return imin(o + ln, OUTN);
}

RX_HD int32_t vecprint_word(int32_t addr, Space sp, int32_t* out, int32_t o, int32_t OUTN) {
    int32_t v[MAX_VEC];
    int32_t ln = sp.vread_hdr(addr, v);
    int32_t n = clampi(imin(ln, OUTN - o), 0, sp.MV);
    for (int32_t k = 0; k < n; ++k) {
        out[2 * (o + k)] = OUT_NUM;
        out[2 * (o + k) + 1] = v[k];
    }
    return imin(o + clampi(ln, 0, sp.MV), OUTN);
}

// -- one node's view: its rows of the stacked fields, at its current task ----

struct Vm {
    Space sp;
    Luts lt;
    int32_t DS, RS, FS, OUTN;
    int32_t *ds, *rs, *fs;                        // the current task's stacks
    int32_t *handlers, *out;
    // The task's scalars, copied into locals (registers) for the whole run
    // and stored back once by store().
    int32_t pc, dsp, rsp, fsp, tstatus, timeout, ev_addr, ev_val;
    int32_t catch_pc, catch_rsp, pending_exc, last_exc, io_op, steps, outp;
    int32_t t, now;

    // Node i's task t (it = i * T + t).
    RX_HD Vm(const Fields& f, const Dims& d, const Tabs& tb, int64_t i, int64_t it)
        : sp{f.cs + i * d.CS, f.mem + i * d.MEM, d.CS, d.MEM, d.MV},
          lt{tb.log10, tb.sg13, tb.sg310, tb.sinq},
          DS(d.DS), RS(d.RS), FS(d.FS), OUTN(d.OUTN),
          ds(f.ds + it * d.DS), rs(f.rs + it * d.RS), fs(f.fs + it * d.FS),
          handlers(f.handlers + i * NUM_EXC), out(f.out + i * 2 * d.OUTN),
          pc(f.pc[it]), dsp(f.dsp[it]), rsp(f.rsp[it]), fsp(f.fsp[it]),
          tstatus(f.tstatus[it]), timeout(f.timeout[it]), ev_addr(f.ev_addr[it]),
          ev_val(f.ev_val[it]), catch_pc(f.catch_pc[it]), catch_rsp(f.catch_rsp[it]),
          pending_exc(f.pending_exc[it]), last_exc(f.last_exc[it]), io_op(f.io_op[it]),
          steps(f.steps[i]), outp(f.outp[i]),
          t((int32_t)(it - i * d.T)), now(f.now[i]) {}

    // Store the scalars back.
    RX_HD void store(const Fields& f, int64_t i, int64_t it) const {
        f.pc[it] = pc; f.dsp[it] = dsp; f.rsp[it] = rsp; f.fsp[it] = fsp;
        f.tstatus[it] = tstatus; f.timeout[it] = timeout; f.ev_addr[it] = ev_addr;
        f.ev_val[it] = ev_val; f.catch_pc[it] = catch_pc; f.catch_rsp[it] = catch_rsp;
        f.pending_exc[it] = pending_exc; f.last_exc[it] = last_exc; f.io_op[it] = io_op;
        f.steps[i] = steps; f.outp[i] = outp;
    }

    // stacks
    RX_HD int32_t dpeek(int32_t k) { return ds[clampi(wsub(dsp, k), 0, DS - 1)]; }
    RX_HD int32_t pop1() {
        int32_t v = ds[clampi(wsub(dsp, 1), 0, DS - 1)];
        dsp = wsub(dsp, 1);
        return v;
    }
    RX_HD void popn(int32_t n, int32_t* v) {
        int32_t p = dsp;
        for (int32_t k = 0; k < n; ++k) v[k] = ds[clampi(wadd(wsub(p, n), k), 0, DS - 1)];
        dsp = wsub(p, n);
    }
    RX_HD void push(int32_t v) {
        ds[clampi(dsp, 0, DS - 1)] = v;
        dsp = wadd(dsp, 1);
    }
    RX_HD int32_t fpeek(int32_t k) { return fs[clampi(wsub(fsp, k), 0, FS - 1)]; }
    RX_HD void fpush(int32_t v) {
        fs[clampi(fsp, 0, FS - 1)] = v;
        fsp = wadd(fsp, 1);
    }
    RX_HD void raise(int32_t code) {
        if (pending_exc == 0) pending_exc = code;
    }

    // output ring
    RX_HD void out_write(int32_t kind, int32_t v) {
        int32_t p = outp;
        if (p < OUTN) {
            out[2 * p] = kind;
            out[2 * p + 1] = v;
            outp = p + 1;
        }
    }

    RX_HD void exec_op(int32_t code);
    RX_HD void step(int32_t p, bool pc_ok, int32_t instr, int32_t meta);
};

// -- the op bodies: exactly the claimed words (ref.SUPPORTED_WORDS); the
// -- declined ones (task, rnd) and FIOS/trap never reach this switch ----------

// The arithmetic words of one shape share one pop and one push: a b -> r
// and x -> r (opcodes below 64, as bit masks).
constexpr uint64_t opbit(int32_t k) { return 1ull << k; }
constexpr uint64_t BINARY_OPS =
    opbit(OP_ADD) | opbit(OP_SUB) | opbit(OP_MUL) | opbit(OP_DIV) | opbit(OP_MOD) |
    opbit(OP_MIN) | opbit(OP_MAX) | opbit(OP_EQ) | opbit(OP_NE) | opbit(OP_LT) | opbit(OP_GT) |
    opbit(OP_LE) | opbit(OP_GE) | opbit(OP_AND) | opbit(OP_OR) | opbit(OP_XOR) |
    opbit(OP_LSHIFT) | opbit(OP_RSHIFT);
constexpr uint64_t UNARY_OPS =
    opbit(OP_NEGATE) | opbit(OP_ABS) | opbit(OP_INC) | opbit(OP_DEC) | opbit(OP_TWOMUL) |
    opbit(OP_TWODIV) | opbit(OP_ZEQ) | opbit(OP_ZLT) | opbit(OP_ZGT) | opbit(OP_INVERT);

RX_HD int32_t alu2(int32_t code, int32_t a, int32_t b) {
    switch (code) {
    case OP_ADD: return wadd(a, b);
    case OP_SUB: return wsub(a, b);
    case OP_MUL: return wmul(a, b);
    case OP_DIV: return truncdiv(a, b);
    case OP_MOD: return truncmod(a, b);
    case OP_MIN: return imin(a, b);
    case OP_MAX: return imax(a, b);
    case OP_EQ: return a == b ? -1 : 0;
    case OP_NE: return a != b ? -1 : 0;
    case OP_LT: return a < b ? -1 : 0;
    case OP_GT: return a > b ? -1 : 0;
    case OP_LE: return a <= b ? -1 : 0;
    case OP_GE: return a >= b ? -1 : 0;
    case OP_AND: return a & b;
    case OP_OR: return a | b;
    case OP_XOR: return a ^ b;
    case OP_LSHIFT: return (int32_t)((uint32_t)a << (b & 31));
    default: return a >> (b & 31);                // OP_RSHIFT
    }
}

RX_HD int32_t alu1(int32_t code, int32_t x) {
    switch (code) {
    case OP_NEGATE: return wneg(x);
    case OP_ABS: return wabs(x);
    case OP_INC: return wadd(x, 1);
    case OP_DEC: return wsub(x, 1);
    case OP_TWOMUL: return wmul(x, 2);
    case OP_TWODIV: return x >> 1;
    case OP_ZEQ: return x == 0 ? -1 : 0;
    case OP_ZLT: return x < 0 ? -1 : 0;
    case OP_ZGT: return x > 0 ? -1 : 0;
    default: return ~x;                           // OP_INVERT
    }
}

RX_HD void Vm::exec_op(int32_t code) {
    int32_t a[4];
    if (code < 64 && ((BINARY_OPS >> code) & 1)) {
        popn(2, a);
        push(alu2(code, a[0], a[1]));
        if ((code == OP_DIV || code == OP_MOD) && a[1] == 0) raise(EXC_DIVBYZERO);
        return;
    }
    if (code < 64 && ((UNARY_OPS >> code) & 1)) {
        push(alu1(code, pop1()));
        return;
    }
    switch (code) {
    case OP_NOP: break;
    case OP_DUP: push(dpeek(1)); break;
    case OP_DROP: pop1(); break;
    case OP_SWAP: popn(2, a); push(a[1]); push(a[0]); break;
    case OP_OVER: push(dpeek(2)); break;
    case OP_ROT: popn(3, a); push(a[1]); push(a[2]); push(a[0]); break;
    case OP_NIP: popn(2, a); push(a[1]); break;
    case OP_TUCK: popn(2, a); push(a[1]); push(a[0]); push(a[1]); break;
    case OP_PICK: {
        int32_t n = pop1();
        int32_t p = dsp;
        int32_t x = ds[clampi(wsub(wsub(p, 1), n), 0, DS - 1)];
        bool bad = (n < 0) || (n >= p);
        push(x);
        if (bad) raise(EXC_STACK);
    } break;
    case OP_TWODUP: { int32_t x = dpeek(2), y = dpeek(1); push(x); push(y); } break;
    case OP_TWODROP: popn(2, a); break;
    case OP_DEPTH: push(dsp); break;
    case OP_MULDIV:
        popn(3, a);
        push(muldiv(a[0], a[1], a[2]));
        if (a[2] == 0) raise(EXC_DIVBYZERO);
        break;
    // memory
    case OP_FETCH: {
        int32_t ad = pop1();
        push(sp.read(ad));
        if (!sp.valid(ad)) raise(EXC_BOUNDS);
    } break;
    case OP_STORE:
        popn(2, a); sp.write(a[1], a[0]);
        if (!sp.valid(a[1])) raise(EXC_BOUNDS);
        break;
    case OP_ADDSTORE:
        popn(2, a); sp.write(a[1], wadd(sp.read(a[1]), a[0]));
        if (!sp.valid(a[1])) raise(EXC_BOUNDS);
        break;
    case OP_GET: {
        popn(2, a);                                   // n arr
        int32_t ln = sp.read(wsub(a[1], 1));
        bool bad = (a[0] < 0) || (a[0] >= ln);
        push(sp.read(wadd(a[1], imin(imax(a[0], 0), imax(wsub(ln, 1), 0)))));
        if (bad) raise(EXC_BOUNDS);
    } break;
    case OP_PUT: {
        popn(3, a);                                   // v n arr
        int32_t ln = sp.read(wsub(a[2], 1));
        bool bad = (a[1] < 0) || (a[1] >= ln);
        if (bad) raise(EXC_BOUNDS);
        else sp.write(wadd(a[2], a[1]), a[0]);
    } break;
    case OP_PUSH: {
        popn(2, a);                                   // v arr
        int32_t top = sp.read(a[1]);
        int32_t ln = sp.read(wsub(a[1], 1));
        if (wadd(top, 1) >= ln) raise(EXC_BOUNDS);
        else {
            sp.write(wadd(wadd(a[1], top), 1), a[0]);
            sp.write(a[1], wadd(top, 1));
        }
    } break;
    case OP_POP: {
        int32_t arr = pop1();
        int32_t top = sp.read(arr);
        bool bad = top <= 0;
        int32_t v = sp.read(wadd(arr, imax(top, 1)));
        push(bad ? 0 : v);
        if (bad) raise(EXC_BOUNDS);
        else sp.write(arr, wsub(top, 1));
    } break;
    case OP_LEN: push(sp.read(wsub(pop1(), 1))); break;
    // control
    case OP_BRANCH: pc = sp.cs_at(pc); break;
    case OP_ZBRANCH: {
        int32_t f = pop1();
        int32_t p = pc;
        pc = f == 0 ? sp.cs_at(p) : p + 1;
    } break;
    case OP_RET:
    case OP_EXIT: {
        int32_t r = rsp;
        bool under = r < 1;
        int32_t ad = rs[clampi(wsub(r, 1), 0, RS - 1)];
        rsp = wsub(r, 1);
        pc = ad;
        if (under) { raise(EXC_STACK); tstatus = ST_ERR; }
    } break;
    case OP_EXEC: {
        int32_t ad = pop1();
        int32_t r = rsp;
        rs[clampi(r, 0, RS - 1)] = pc;
        rsp = wadd(r, 1);
        pc = ad;
        if (r >= RS) raise(EXC_STACK);
    } break;
    case OP_DOINIT: popn(2, a); fpush(a[0]); fpush(a[1]); break;
    case OP_DOLOOP: {
        int32_t p = pc;
        int32_t top_addr = sp.cs_at(p);
        int32_t limit = fpeek(2);
        int32_t ctr = wadd(fpeek(1), 1);
        bool done = ctr >= limit;
        fs[clampi(wsub(fsp, 1), 0, FS - 1)] = ctr;
        if (done) fsp = wsub(fsp, 2);
        pc = done ? p + 1 : top_addr;
    } break;
    case OP_I: push(fpeek(1)); break;
    case OP_J: push(fpeek(3)); break;
    case OP_UNLOOP: fsp = wsub(fsp, 2); break;
    case OP_HALT: tstatus = ST_HALT; break;
    case OP_END: tstatus = t == 0 ? ST_DONE : ST_FREE; break;
    case OP_DLIT: { int32_t p = pc; push(sp.cs_at(p)); pc = p + 1; } break;
    // io / printing
    case OP_PRINT: out_write(OUT_NUM, pop1()); break;
    case OP_EMIT: out_write(OUT_CHR, pop1()); break;
    case OP_CR: out_write(OUT_CHR, 10); break;
    case OP_PRSTR: {
        int32_t p = pc;
        int32_t ln = clampi(sp.cs_at(p), 0, MAXSTR);
        outp = prstr_word(p + 1, ln, sp, out, outp, OUTN);
        pc = p + 1 + ln;
    } break;
    case OP_VECPRINT: outp = vecprint_word(pop1(), sp, out, outp, OUTN); break;
    case OP_OUT:
    case OP_IN:
    case OP_SEND:
    case OP_RECEIVE:
        // Rewind pc so the host re-inspects the op; args stay on DS.
        pc = pc - 1;
        io_op = code;
        tstatus = ST_IOWAIT;
        break;
    // tasks (non-spawning)
    case OP_YIELD: tstatus = ST_YIELD; break;
    case OP_SLEEP: timeout = wadd(now, pop1()); tstatus = ST_SLEEP; break;
    case OP_AWAIT:
        popn(3, a);                                   // ms value varaddr
        timeout = wadd(now, a[0]);
        ev_addr = a[2];
        ev_val = a[1];
        tstatus = ST_EVENT;
        break;
    case OP_TASKID: push(t); break;
    case OP_MS: push(now); break;
    case OP_STEPS: push(steps); break;
    // exceptions
    case OP_EXCEPTION: popn(2, a); handlers[clampi(a[1], 0, NUM_EXC - 1)] = a[0]; break;
    case OP_CATCH:
        push(last_exc);
        last_exc = 0;
        catch_pc = pc - 1;
        catch_rsp = rsp;
        break;
    case OP_THROW: raise(clampi(pop1(), 1, NUM_EXC - 1)); break;
    // fixed-point DSP scalars
    case OP_SIN:
    case OP_LOG:
    case OP_SIGMOID:
    case OP_SQRT: push(dsp_word(code, pop1(), lt)); break;
    case OP_RELU: push(imax(pop1(), 0)); break;
    // vector / ANN words
    case OP_FILL: popn(2, a); vec_store_word(code, a[0], a[1], 0, 0, sp, lt); break;
    case OP_VECLOAD:
    case OP_VECSCALE: popn(3, a); vec_store_word(code, a[0], a[1], a[2], 0, sp, lt); break;
    case OP_VECADD:
    case OP_VECMUL:
    case OP_VECFOLD:
    case OP_VECMAP:
    case OP_HULL:
    case OP_LOWP:
    case OP_HIGHP: popn(4, a); vec_store_word(code, a[0], a[1], a[2], a[3], sp, lt); break;
    case OP_DOTPROD: popn(2, a); push(vec_reduce_word(code, a[0], a[1], sp)); break;
    case OP_VECMAX: push(vec_reduce_word(code, pop1(), 0, sp)); break;
    default: break;
    }
}

// One instruction of the current task (interp.py _step_group + _finish),
// the cell `instr` fetched at p = pc, with its opcode's packed `meta`.
RX_HD void Vm::step(int32_t p, bool pc_ok, int32_t instr, int32_t meta) {
    int32_t tag = instr & 3;
    int32_t payload = instr >> 2;
    if (!pc_ok) {
        raise(EXC_TRAP);
        tstatus = ST_ERR;
    } else if (tag == 2) {
        if (rsp >= RS) raise(EXC_STACK);
        else {
            rs[clampi(rsp, 0, RS - 1)] = p + 1;
            rsp = wadd(rsp, 1);
            pc = payload;
        }
    } else {
        pc = p + 1;
        if (tag == 1) {
            if (dsp >= DS) raise(EXC_STACK);
            else push(payload);
        } else if (tag == 3) {
            raise(EXC_TRAP);
        } else {
            int32_t din = meta_din(meta), dout = meta_dout(meta);
            int32_t fin = meta_fin(meta), fout = meta_fout(meta);
            bool under = (dsp < din) || (fsp < fin);
            bool over = (wadd(wsub(dsp, din), dout) > DS) || (wadd(wsub(fsp, fin), fout) > FS);
            if (under || over) raise(EXC_STACK);
            else exec_op(clampi(payload, 0, NUM_OPS));
        }
    }
    steps = wadd(steps, 1);
    int32_t pend = pending_exc;
    if (pend > 0) {
        // Exception dispatch (paper §3.8): align RS to the catch point,
        // push it as the return address, enter the handler.
        int32_t code = clampi(pend, 0, NUM_EXC - 1);
        int32_t handler = handlers[code];
        last_exc = code;
        pending_exc = 0;
        if (handler > 0) {
            int32_t crsp = clampi(catch_rsp, 0, RS - 1);
            rs[crsp] = catch_pc;
            rsp = crsp + 1;
            pc = handler;
        } else {
            tstatus = ST_ERR;
        }
    }
}

// -- one launch row -------------------------------------------------------------

// Row j of a launch over `n_rows` rows: its node (rows[j], or j without a
// row list; -1 past the rows or outside [0, n_nodes)) and its budget
// (budget[j], or `steps` without one).
struct Row {
    int64_t node;
    int32_t budget;
};

RX_HD Row launch_row(const int32_t* rows, const int32_t* budget, int32_t n_nodes, int32_t steps,
                     int64_t j, int32_t n_rows) {
    Row r{-1, 0};
    if (j >= n_rows) return r;
    int64_t i = rows ? rows[j] : j;
    if (i < 0 || i >= n_nodes) return r;
    r.node = i;
    r.budget = budget ? budget[j] : steps;
    return r;
}

// The task a row runs, as it = node * T + t: the node's current task when
// it is ST_RUN and the row has budget; else -1 (nothing runs).
RX_HD int64_t row_task(const Fields& f, const Dims& d, Row r) {
    if (r.node < 0 || r.budget <= 0) return -1;
    int64_t it = r.node * d.T + f.cur[r.node];
    return f.tstatus[it] == ST_RUN ? it : -1;
}

// Alg. 1 restricted to the claimed words: row j runs up to its budget of
// instructions of its task (row_task); stops on the budget, on a status
// change, or before the first declined instruction (ref.run_core).  `meta`
// is the packed opcode table (NUM_OPS + 1 words).
// The counting instance (OBS) also adds each retired instruction to its bin
// in `hist` (NUM_BINS cells, zeroed by the caller): the opcode for tag 0
// (clipped to NUM_OPS), NUM_OPS + tag for a literal, a call or a reserved
// tag, NUM_OPS + 3 for an invalid pc.  The declined instruction it stops
// before is not retired, and not binned.
template <bool OBS = false>
RX_HD void run_core(const Fields& f, const Dims& d, const Tabs& tb, const int32_t* meta,
                    int64_t j, Row r, int32_t* n_exec, int32_t* bailed, int32_t* bail_op,
                    int32_t* hist = nullptr) {
    const int64_t it = row_task(f, d, r);
    int32_t n = 0, op = -1;
    if (it >= 0) {
        Vm vm(f, d, tb, r.node, it);
        while (n < r.budget && vm.tstatus == ST_RUN) {
            int32_t p = vm.pc;
            bool pc_ok = p >= 0 && p < d.CS;
            int32_t instr = vm.sp.cs_at(p);
            int32_t code = clampi(instr >> 2, 0, NUM_OPS);
            int32_t m = (instr & 3) == 0 ? meta[code] : 1;
            if (pc_ok && !(m & 1)) {
                op = code;
                break;
            }
            if constexpr (OBS)
                ++hist[!pc_ok ? NUM_OPS + 3 : (instr & 3) == 0 ? code : NUM_OPS + (instr & 3)];
            vm.step(p, pc_ok, instr, m);
            ++n;
        }
        vm.store(f, r.node, it);
    }
    n_exec[j] = n;
    bailed[j] = op >= 0 ? 1 : 0;
    bail_op[j] = op;
}

}  // namespace rexavm
