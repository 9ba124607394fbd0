/* srcore: host-side tree flattening for the port, as a CPython extension.
 *
 * Walks Python `Node` graphs (tree.py) in postorder (l, r, parent), the
 * order of `Node.postorder`, and writes them straight into preallocated
 * numpy buffers, in one of two layouts:
 *
 * - flatten_batch(trees, kind, op, lhs, rhs, feat, val, length): the
 *   FlatTrees struct of arrays (ops/flat.py flatten_trees), int32 [P, N]
 *   five times, float32 [P, N], int32 [P];
 * - slab_fill(trees, ints, vals, start, n_slots, bin_off): B1's packed rows
 *   (ops/flat.py FlatSlab.set_tree; ops/interp_cuda.pack_programs_fused),
 *   int32 [cap, >= 4N+1] = code | lhs | rhs | feat | length, float32
 *   [cap, >= N]; code = 0 const, 1 var, 2+op unary, bin_off+op binary.
 *
 * Each function's output is the plain Python flatten's, integer for integer
 * and bit for bit in the constants. A node that a graph-node DAG reaches
 * more than once is expanded at every use, and a parent points at the
 * shared node's most recent slot, as the Python `slot_of[id(n)] = i` does.
 * A tree of more than N slots raises ValueError. A constant's double goes
 * to float32 as numpy's cast takes it (round to nearest; ±inf beyond the
 * range), made explicit where C leaves it undefined.
 *
 * The slot map is a linear-probe hash of 2N entries (N = the row width),
 * cleared once per tree. Per call scratch, so calls from several threads do
 * not share state; the interpreter lock is held throughout.
 *
 * Kind codes must match ops/flat.py: PAD=0 CONST=1 VAR=2 UNARY=3 BINARY=4.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#define KIND_CONST 1
#define KIND_VAR 2
#define KIND_UNARY 3
#define KIND_BINARY 4

/* the widest row the extension takes (MAX_NODES in native/__init__.py) */
#define MAX_NODES 4096

/* the midpoint between FLT_MAX and 2^128: a double at or beyond it rounds
 * to inf in float32 (ties to even, FLT_MAX's last bit being odd), one below
 * it to FLT_MAX */
#define F32_OVERFLOW 0x1.ffffffp+127

static PyObject *s_degree, *s_is_const, *s_val, *s_feat, *s_op, *s_l, *s_r;

typedef struct {
    PyObject *node; /* a strong reference, released when the entry is emitted */
    long degree;
    int expanded;
} Entry;

/* one call's scratch for rows of N slots */
typedef struct {
    int n;
    size_t cap;      /* hash entries, 2N (at least 2) */
    void **keys;     /* node pointers (compared, never dereferenced) */
    int32_t *slots;  /* the key's most recent slot */
    Entry *stack;    /* N + 3 entries: the walk never holds more (emit_tree) */
} Scratch;

/* where one row goes: the FlatTrees arrays, or a slab row (kind = code) */
typedef struct {
    int32_t *kind, *op, *lhs, *rhs, *feat;
    float *val;
    int slab;
    int bin_off;
} Row;

static int scratch_init(Scratch *s, int n) {
    s->n = n;
    s->cap = (size_t)(n > 0 ? 2 * n : 2);
    s->keys = PyMem_Malloc(sizeof(void *) * s->cap);
    s->slots = PyMem_Malloc(sizeof(int32_t) * s->cap);
    s->stack = PyMem_Malloc(sizeof(Entry) * (size_t)(n + 3));
    if (!s->keys || !s->slots || !s->stack) {
        PyMem_Free(s->keys);
        PyMem_Free(s->slots);
        PyMem_Free(s->stack);
        PyErr_NoMemory();
        return -1;
    }
    return 0;
}

static void scratch_free(Scratch *s) {
    PyMem_Free(s->keys);
    PyMem_Free(s->slots);
    PyMem_Free(s->stack);
}

static inline void slot_put(Scratch *s, void *k, int32_t v) {
    size_t h = ((uintptr_t)k >> 4) % s->cap;
    while (s->keys[h] != NULL && s->keys[h] != k) h = (h + 1) % s->cap;
    s->keys[h] = k;
    s->slots[h] = v;
}

static inline int32_t slot_get(const Scratch *s, void *k) {
    size_t h = ((uintptr_t)k >> 4) % s->cap;
    while (s->keys[h] != NULL) {
        if (s->keys[h] == k) return s->slots[h];
        h = (h + 1) % s->cap;
    }
    return -1;
}

/* attribute readers: 0 on success, -1 with an exception set */
static int get_long(PyObject *o, PyObject *name, long *out) {
    PyObject *a = PyObject_GetAttr(o, name);
    if (a == NULL) return -1;
    *out = PyLong_AsLong(a); /* takes __index__: Python and numpy integers */
    Py_DECREF(a);
    return (*out == -1 && PyErr_Occurred()) ? -1 : 0;
}

static int get_int32(PyObject *o, PyObject *name, int32_t *out) {
    long v;
    if (get_long(o, name, &v) < 0) return -1;
    if (v < INT32_MIN || v > INT32_MAX) {
        PyErr_Format(PyExc_OverflowError, "srcore: %ld out of bounds for int32", v);
        return -1;
    }
    *out = (int32_t)v;
    return 0;
}

static int get_double(PyObject *o, PyObject *name, double *out) {
    PyObject *a = PyObject_GetAttr(o, name);
    if (a == NULL) return -1;
    *out = PyFloat_AsDouble(a); /* takes __float__: numpy floats too */
    Py_DECREF(a);
    return (*out == -1.0 && PyErr_Occurred()) ? -1 : 0;
}

static int get_bool(PyObject *o, PyObject *name, int *out) {
    PyObject *a = PyObject_GetAttr(o, name);
    if (a == NULL) return -1;
    *out = PyObject_IsTrue(a);
    Py_DECREF(a);
    return *out < 0 ? -1 : 0;
}

static inline float to_f32(double v) {
    if (v > FLT_MAX || v < -FLT_MAX) { /* false for NaN */
        float r = fabs(v) >= F32_OVERFLOW ? INFINITY : FLT_MAX;
        return v < 0 ? -r : r;
    }
    return (float)v;
}

/* the slot of a child: -1 with an exception set when it has none */
static int32_t child_slot(const Scratch *s, PyObject *n, PyObject *name) {
    PyObject *c = PyObject_GetAttr(n, name);
    if (c == NULL) return -1;
    int32_t slot = slot_get(s, (void *)c);
    Py_DECREF(c);
    if (slot < 0)
        PyErr_SetString(PyExc_RuntimeError, "srcore: a child was not emitted before its parent");
    return slot;
}

/* write the node of entry e at slot i */
static int emit_node(const Entry *e, int i, const Row *row, Scratch *s) {
    PyObject *n = e->node;
    slot_put(s, (void *)n, i);
    if (e->degree == 0) {
        int is_const;
        if (get_bool(n, s_is_const, &is_const) < 0) return -1;
        if (is_const) {
            double v;
            if (get_double(n, s_val, &v) < 0) return -1;
            row->kind[i] = row->slab ? 0 : KIND_CONST;
            row->val[i] = to_f32(v);
        } else {
            if (get_int32(n, s_feat, &row->feat[i]) < 0) return -1;
            row->kind[i] = row->slab ? 1 : KIND_VAR;
        }
        return 0;
    }
    int32_t op;
    if (get_int32(n, s_op, &op) < 0) return -1;
    int32_t l = child_slot(s, n, s_l);
    if (l < 0) return -1;
    row->lhs[i] = l;
    if (e->degree == 1) {
        if (row->slab) {
            row->kind[i] = 2 + op;
        } else {
            row->kind[i] = KIND_UNARY;
            row->op[i] = op;
        }
        return 0;
    }
    int32_t r = child_slot(s, n, s_r);
    if (r < 0) return -1;
    row->rhs[i] = r;
    if (row->slab) {
        row->kind[i] = row->bin_off + op;
    } else {
        row->kind[i] = KIND_BINARY;
        row->op[i] = op;
    }
    return 0;
}

static int push(Scratch *s, int *sp, PyObject *n, PyObject *name) {
    PyObject *c = PyObject_GetAttr(n, name);
    if (c == NULL) return -1;
    s->stack[(*sp)++] = (Entry){c, 0, 0};
    return 0;
}

/* Emit tree p into a zeroed row; returns its slot count, or -1 with an
 * exception set. The stack holds occurrences not emitted yet, so emitted +
 * stacked never exceeds the tree's slot count: once it exceeds N the tree
 * cannot fit, and the stack never holds more than N + 2 entries. */
static int emit_tree(PyObject *root, Py_ssize_t p, const Row *row, Scratch *s) {
    const int N = s->n;
    Entry *st = s->stack;
    int sp = 0, out = 0;

    memset(s->keys, 0, sizeof(void *) * s->cap);
    Py_INCREF(root);
    st[sp++] = (Entry){root, 0, 0};
    while (sp > 0) {
        Entry *e = &st[sp - 1];
        if (!e->expanded) {
            PyObject *n = e->node;
            if (get_long(n, s_degree, &e->degree) < 0) goto fail;
            e->expanded = 1;
            /* r first, so that l is on top: (l, r, parent) */
            if (e->degree == 2 && push(s, &sp, n, s_r) < 0) goto fail;
            if (e->degree >= 1 && push(s, &sp, n, s_l) < 0) goto fail;
            if (out + sp > N) {
                PyErr_Format(PyExc_ValueError, "tree %zd has more than max_nodes=%d nodes", p, N);
                goto fail;
            }
            continue;
        }
        Entry done = *e;
        sp--;
        int rc = emit_node(&done, out, row, s);
        Py_DECREF(done.node);
        if (rc < 0) goto fail;
        out++;
    }
    return out;

fail:
    while (sp > 0) Py_DECREF(st[--sp].node);
    return -1;
}

/* a writable C-contiguous buffer of 4-byte items: 'f' float32, 'i' int32 */
static int get_buf(PyObject *obj, Py_buffer *b, char type, const char *what) {
    if (PyObject_GetBuffer(obj, b, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) != 0)
        return -1;
    const char *f = b->format ? b->format : "B";
    if (*f == '@' || *f == '=' || *f == '<') f++;
    int ok = b->itemsize == 4 &&
             (type == 'f' ? strcmp(f, "f") == 0 : (strcmp(f, "i") == 0 || strcmp(f, "l") == 0));
    if (!ok) {
        PyBuffer_Release(b);
        PyErr_Format(PyExc_TypeError, "srcore: %s must be %s", what,
                     type == 'f' ? "float32" : "int32");
        return -1;
    }
    return 0;
}

static PyObject *flatten_batch(PyObject *self, PyObject *args) {
    PyObject *trees, *objs[7];
    static const char *names[7] = {"kind", "op", "lhs", "rhs", "feat", "val", "length"};
    if (!PyArg_ParseTuple(args, "OOOOOOOO", &trees, &objs[0], &objs[1], &objs[2], &objs[3],
                          &objs[4], &objs[5], &objs[6]))
        return NULL;
    PyObject *seq = PySequence_Fast(trees, "srcore: trees must be a sequence");
    if (seq == NULL) return NULL;
    Py_buffer b[7];
    int held = 0;
    PyObject *result = NULL;
    for (; held < 7; held++)
        if (get_buf(objs[held], &b[held], held == 5 ? 'f' : 'i', names[held]) < 0) goto done;

    Py_ssize_t P = PySequence_Fast_GET_SIZE(seq);
    if (b[0].ndim != 2) {
        PyErr_SetString(PyExc_ValueError, "srcore: kind must be 2-D [P, N]");
        goto done;
    }
    Py_ssize_t rows = b[0].shape[0], N = b[0].shape[1];
    if (N > MAX_NODES || P > rows) {
        PyErr_Format(PyExc_ValueError, "srcore: %zd trees into [%zd, %zd] (at most %d slots)",
                     P, rows, N, MAX_NODES);
        goto done;
    }
    for (int g = 1; g < 6; g++) {
        if (b[g].ndim != 2 || b[g].shape[0] != rows || b[g].shape[1] != N) {
            PyErr_SetString(PyExc_ValueError, "srcore: op/lhs/rhs/feat/val shape must match kind");
            goto done;
        }
    }
    if (b[6].len / (Py_ssize_t)sizeof(int32_t) < P) {
        PyErr_SetString(PyExc_ValueError, "srcore: length buffer smaller than number of trees");
        goto done;
    }
    Scratch s;
    if (scratch_init(&s, (int)N) < 0) goto done;
    for (Py_ssize_t p = 0; p < P; p++) {
        Row row = {
            (int32_t *)b[0].buf + p * N, (int32_t *)b[1].buf + p * N,
            (int32_t *)b[2].buf + p * N, (int32_t *)b[3].buf + p * N,
            (int32_t *)b[4].buf + p * N, (float *)b[5].buf + p * N, 0, 0,
        };
        for (int g = 0; g < 6; g++) memset((char *)b[g].buf + 4 * p * N, 0, 4 * (size_t)N);
        int n = emit_tree(PySequence_Fast_GET_ITEM(seq, p), p, &row, &s);
        if (n < 0) {
            scratch_free(&s);
            goto done;
        }
        ((int32_t *)b[6].buf)[p] = n;
    }
    scratch_free(&s);
    result = Py_None;
    Py_INCREF(result);

done:
    while (held > 0) PyBuffer_Release(&b[--held]);
    Py_DECREF(seq);
    return result;
}

static PyObject *slab_fill(PyObject *self, PyObject *args) {
    PyObject *trees, *a_ints, *a_vals;
    int start, N, bin_off;
    if (!PyArg_ParseTuple(args, "OOOiii", &trees, &a_ints, &a_vals, &start, &N, &bin_off))
        return NULL;
    PyObject *seq = PySequence_Fast(trees, "srcore: trees must be a sequence");
    if (seq == NULL) return NULL;
    Py_buffer ints, vals;
    PyObject *result = NULL;
    if (get_buf(a_ints, &ints, 'i', "ints") < 0) {
        Py_DECREF(seq);
        return NULL;
    }
    if (get_buf(a_vals, &vals, 'f', "vals") < 0) {
        PyBuffer_Release(&ints);
        Py_DECREF(seq);
        return NULL;
    }
    Py_ssize_t P = PySequence_Fast_GET_SIZE(seq);
    if (ints.ndim != 2 || vals.ndim != 2) {
        PyErr_SetString(PyExc_ValueError, "srcore slab_fill: ints/vals must be 2-D");
        goto done;
    }
    Py_ssize_t L = ints.shape[1], Lv = vals.shape[1];
    if (N < 0 || N > MAX_NODES || start < 0 || start + P > ints.shape[0] ||
        start + P > vals.shape[0] || 4 * (Py_ssize_t)N + 1 > L || (Py_ssize_t)N > Lv) {
        PyErr_SetString(PyExc_ValueError, "srcore slab_fill bounds check failed");
        goto done;
    }
    Scratch s;
    if (scratch_init(&s, N) < 0) goto done;
    for (Py_ssize_t p = 0; p < P; p++) {
        int32_t *r = (int32_t *)ints.buf + (start + p) * L;
        float *v = (float *)vals.buf + (start + p) * Lv;
        memset(r, 0, sizeof(int32_t) * (size_t)(4 * N + 1));
        memset(v, 0, sizeof(float) * (size_t)N);
        Row row = {r, NULL, r + N, r + 2 * N, r + 3 * N, v, 1, bin_off};
        int n = emit_tree(PySequence_Fast_GET_ITEM(seq, p), p, &row, &s);
        if (n < 0) {
            scratch_free(&s);
            goto done;
        }
        r[4 * N] = n;
    }
    scratch_free(&s);
    result = Py_None;
    Py_INCREF(result);

done:
    PyBuffer_Release(&ints);
    PyBuffer_Release(&vals);
    Py_DECREF(seq);
    return result;
}

static PyMethodDef methods[] = {
    {"flatten_batch", flatten_batch, METH_VARARGS,
     "flatten_batch(trees, kind, op, lhs, rhs, feat, val, length): flatten Node trees "
     "into FlatTrees-layout numpy buffers."},
    {"slab_fill", slab_fill, METH_VARARGS,
     "slab_fill(trees, ints, vals, start, n_slots, bin_off): flatten Node trees into "
     "B1's packed rows start, start+1, ..."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_srcore_torch", "the port's host-side tree flattening", -1,
    methods,
};

PyMODINIT_FUNC PyInit__srcore_torch(void) {
    s_degree = PyUnicode_InternFromString("degree");
    s_is_const = PyUnicode_InternFromString("is_const");
    s_val = PyUnicode_InternFromString("val");
    s_feat = PyUnicode_InternFromString("feat");
    s_op = PyUnicode_InternFromString("op");
    s_l = PyUnicode_InternFromString("l");
    s_r = PyUnicode_InternFromString("r");
    if (!s_degree || !s_is_const || !s_val || !s_feat || !s_op || !s_l || !s_r) return NULL;
    return PyModule_Create(&moduledef);
}
