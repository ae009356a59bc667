// libminigpt4_torch — C ABI shared library for the PyTorch/CUDA MiniGPT-4
// engine (minigpt4_tpu_torch).
//
// Exports the 18 functions of the reference ABI (minigpt4.h, the same header
// as the JAX package's library) with identical signatures, enums and error
// codes, so existing C/ctypes clients (minigpt4_library.py,
// examples/main.c) link and run unchanged.  The compute path is hosted by an
// embedded CPython running the minigpt4_tpu_torch package: this library owns
// interpreter startup, GIL discipline and value marshalling; PyTorch and the
// package's CUDA kernels own the GPU (the device is MINIGPT4_TPU_DEVICE,
// default cuda; see c_api/capi_host.py).
//
// Threading model: every exported call acquires the GIL (PyGILState_Ensure)
// so the ABI is callable from any thread, matching the reference's
// stateless-entry design.  n_threads parameters are accepted and ignored.
//
// Build: python -m minigpt4_tpu_torch.c_api._build (g++ alone; the flags
// come from sysconfig) -> build/capi_torch/libminigpt4_torch.so.

#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

#include "minigpt4.h"

namespace {

// Error codes mirror MiniGPT4Error (minigpt4.cpp:97-119 / utils.py).
enum ErrorCode : int {
    kNone = 0,
    kLoadModelFileHeader = 1,
    kLoadModelFileVersion = 2,
    kLoadModelDataType = 3,
    kLoadLanguageModel = 4,
    kOpenImage = 5,
    kImageSize = 6,
    kFailedToAddString = 8,
    kProjInvalidSize = 9,
    kFailedToAddEmbedding = 10,
    kEosToken = 11,
    kEos = 12,
    kImageNot224 = 13,
    kImageNotF32 = 14,
    kImageChannelsExpectedRGB = 15,
    kImageFormatExpectedU8 = 16,
    kPathDoesNotExist = 17,
};

std::once_flag g_py_once;
bool g_py_ok = false;

void init_python() {
    std::call_once(g_py_once, [] {
        if (!Py_IsInitialized()) {
            PyConfig config;
            PyConfig_InitPythonConfig(&config);
            // keep signal handlers with the host application
            config.install_signal_handlers = 0;
            PyStatus status = Py_InitializeFromConfig(&config);
            PyConfig_Clear(&config);
            if (PyStatus_Exception(status)) {
                std::fprintf(stderr, "[minigpt4] embedded Python init failed\n");
                return;
            }
            // release the GIL acquired by initialization
            PyEval_SaveThread();
        }
        g_py_ok = true;
    });
}

// RAII GIL holder
class Gil {
  public:
    Gil() : state_(PyGILState_Ensure()) {}
    ~Gil() { PyGILState_Release(state_); }

  private:
    PyGILState_STATE state_;
};

void print_py_error() {
    if (PyErr_Occurred()) PyErr_Print();
}

// Map the pending Python exception to a reference error code: typed errors
// (utils.MiniGPT4TypedError) carry the exact enum value in .minigpt4_code
// (the reference returns distinct MiniGPT4Error values per failure,
// minigpt4.cpp:97-119); anything else keeps the entry point's fallback.
// Consumes and prints the pending exception.
int py_error_code(int fallback) {
    if (!PyErr_Occurred()) return fallback;
    PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &value, &tb);
    PyErr_NormalizeException(&type, &value, &tb);
    int rc = fallback;
    if (value) {
        if (PyObject* code = PyObject_GetAttrString(value, "minigpt4_code")) {
            if (PyLong_Check(code)) rc = static_cast<int>(PyLong_AsLong(code));
            Py_DECREF(code);
        } else {
            PyErr_Clear();  // no attribute: keep the fallback
        }
    }
    PyErr_Restore(type, value, tb);
    PyErr_Print();
    return rc;
}

// The engine context: a CPython object (capi_host.Host instance).
struct MiniGPT4ContextImpl {
    PyObject* host;  // owned
};

PyObject* import_host_class() {
    PyObject* mod = PyImport_ImportModule("minigpt4_tpu_torch.c_api.capi_host");
    if (!mod) {
        print_py_error();
        return nullptr;
    }
    PyObject* cls = PyObject_GetAttrString(mod, "Host");
    Py_DECREF(mod);
    if (!cls) print_py_error();
    return cls;
}

// Call a 0..n-arg method returning a new reference (nullptr on error).
PyObject* call_method(PyObject* obj, const char* name, PyObject* args /* borrowed tuple */) {
    // on failure the Python exception is left PENDING so the caller can map
    // it to a reference error code via py_error_code(fallback)
    PyObject* meth = PyObject_GetAttrString(obj, name);
    if (!meth) return nullptr;
    PyObject* res = PyObject_CallObject(meth, args);
    Py_DECREF(meth);
    return res;
}

int call_int_method(PyObject* obj, const char* name, PyObject* args, int error_code) {
    PyObject* res = call_method(obj, name, args);
    if (!res) return py_error_code(error_code);
    int rc = kNone;
    if (res == Py_None) {
        rc = kNone;
    } else if (PyLong_Check(res)) {
        rc = static_cast<int>(PyLong_AsLong(res));
    }
    Py_DECREF(res);
    return rc;
}

}  // namespace

extern "C" {

struct MiniGPT4Context* minigpt4_model_load(const char* path, const char* llm_model, int verbosity,
                                            int seed, int n_ctx, int n_batch, bool numa) {
    (void)numa;  // accepted for ABI parity (minigpt4.h:97)
    init_python();
    if (!g_py_ok) return nullptr;
    Gil gil;
    PyObject* cls = import_host_class();
    if (!cls) return nullptr;
    PyObject* args = Py_BuildValue("(ssiiii)", path, llm_model, verbosity, seed, n_ctx, n_batch);
    PyObject* host = PyObject_CallObject(cls, args);
    Py_DECREF(cls);
    Py_XDECREF(args);
    if (!host) {
        print_py_error();
        return nullptr;
    }
    auto* ctx = new MiniGPT4ContextImpl{host};
    return reinterpret_cast<MiniGPT4Context*>(ctx);
}

int minigpt4_image_load_from_file(struct MiniGPT4Context* ctx, const char* path,
                                  struct MiniGPT4Image* image, int flags) {
    (void)flags;
    Gil gil;
    auto* impl = reinterpret_cast<MiniGPT4ContextImpl*>(ctx);
    PyObject* args = Py_BuildValue("(s)", path);
    PyObject* res = call_method(impl->host, "image_load_from_file", args);
    Py_XDECREF(args);
    if (!res) return py_error_code(kOpenImage);
    // res = (bytes, width, height, channels)
    PyObject* data;
    int w, h, c;
    if (!PyArg_ParseTuple(res, "Oiii", &data, &w, &h, &c)) {
        Py_DECREF(res);
        return kOpenImage;
    }
    Py_ssize_t n = PyBytes_Size(data);
    void* buf = std::malloc(static_cast<size_t>(n));
    std::memcpy(buf, PyBytes_AsString(data), static_cast<size_t>(n));
    Py_DECREF(res);
    image->data = buf;
    image->width = w;
    image->height = h;
    image->channels = c;
    image->format = MINIGPT4_IMAGE_FORMAT_U8;
    return kNone;
}

int minigpt4_preprocess_image(struct MiniGPT4Context* ctx, const struct MiniGPT4Image* image,
                              struct MiniGPT4Image* preprocessed_image, int flags) {
    (void)flags;
    if (image->channels != 3) return kImageChannelsExpectedRGB;
    if (image->format != MINIGPT4_IMAGE_FORMAT_U8) return kImageFormatExpectedU8;
    Gil gil;
    auto* impl = reinterpret_cast<MiniGPT4ContextImpl*>(ctx);
    PyObject* bytes = PyBytes_FromStringAndSize(
        static_cast<const char*>(image->data),
        static_cast<Py_ssize_t>(image->width) * image->height * image->channels);
    PyObject* args = Py_BuildValue("(Oii)", bytes, image->width, image->height);
    Py_DECREF(bytes);
    PyObject* res = call_method(impl->host, "preprocess_image", args);
    Py_XDECREF(args);
    if (!res) return py_error_code(kImageSize);
    PyObject* data;
    int size;
    if (!PyArg_ParseTuple(res, "Oi", &data, &size)) {
        Py_DECREF(res);
        return kImageNot224;
    }
    Py_ssize_t n = PyBytes_Size(data);
    void* buf = std::malloc(static_cast<size_t>(n));
    std::memcpy(buf, PyBytes_AsString(data), static_cast<size_t>(n));
    Py_DECREF(res);
    preprocessed_image->data = buf;
    preprocessed_image->width = size;
    preprocessed_image->height = size;
    preprocessed_image->channels = 3;
    preprocessed_image->format = MINIGPT4_IMAGE_FORMAT_F32;
    return kNone;
}

int minigpt4_encode_image(struct MiniGPT4Context* ctx, struct MiniGPT4Image* image,
                          struct MiniGPT4Embedding* embedding, size_t n_threads) {
    (void)n_threads;
    if (image->format != MINIGPT4_IMAGE_FORMAT_F32) return kImageNotF32;
    Gil gil;
    auto* impl = reinterpret_cast<MiniGPT4ContextImpl*>(ctx);
    Py_ssize_t n = static_cast<Py_ssize_t>(image->width) * image->height * image->channels *
                   static_cast<Py_ssize_t>(sizeof(float));
    PyObject* bytes = PyBytes_FromStringAndSize(static_cast<const char*>(image->data), n);
    PyObject* args = Py_BuildValue("(Oii)", bytes, image->width, image->height);
    Py_DECREF(bytes);
    PyObject* res = call_method(impl->host, "encode_image", args);
    Py_XDECREF(args);
    if (!res) return py_error_code(kImageNot224);
    // res = bytes of float32
    Py_ssize_t nb = PyBytes_Size(res);
    auto* buf = static_cast<float*>(std::malloc(static_cast<size_t>(nb)));
    std::memcpy(buf, PyBytes_AsString(res), static_cast<size_t>(nb));
    Py_DECREF(res);
    embedding->data = buf;
    embedding->elements = static_cast<size_t>(nb) / sizeof(float);
    return kNone;
}

int minigpt4_begin_chat_image(struct MiniGPT4Context* ctx, struct MiniGPT4Embedding* image_embedding,
                              const char* s, size_t n_threads) {
    (void)n_threads;
    Gil gil;
    auto* impl = reinterpret_cast<MiniGPT4ContextImpl*>(ctx);
    PyObject* bytes = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(image_embedding->data),
        static_cast<Py_ssize_t>(image_embedding->elements * sizeof(float)));
    PyObject* args = Py_BuildValue("(Os)", bytes, s);
    Py_DECREF(bytes);
    int rc = call_int_method(impl->host, "begin_chat_image", args, kProjInvalidSize);
    Py_XDECREF(args);
    return rc;
}

static int end_chat_common(struct MiniGPT4Context* ctx, const char** token, float temp, int32_t top_k,
                           float top_p, float tfs_z, float typical_p, int32_t repeat_last_n,
                           float repeat_penalty, float alpha_presence, float alpha_frequency,
                           int mirostat, float mirostat_tau, float mirostat_eta, int penalize_nl) {
    Gil gil;
    auto* impl = reinterpret_cast<MiniGPT4ContextImpl*>(ctx);
    PyObject* args = Py_BuildValue("(fifffifffifff)", temp, top_k, top_p, tfs_z, typical_p,
                                   repeat_last_n, repeat_penalty, alpha_presence, alpha_frequency,
                                   mirostat, mirostat_tau, mirostat_eta,
                                   static_cast<float>(penalize_nl));
    PyObject* res = call_method(impl->host, "end_chat", args);
    Py_XDECREF(args);
    if (!res) return py_error_code(kFailedToAddString);
    // token string lifetime: the host keeps the last token alive; copy into a
    // per-context buffer (the reference returns llama.cpp-owned storage with
    // the same next-call invalidation semantics)
    const char* t = PyUnicode_AsUTF8(res);
    static thread_local std::string last_token;
    last_token = t ? t : "";
    *token = last_token.c_str();
    Py_DECREF(res);
    return kNone;
}

int minigpt4_end_chat_image(struct MiniGPT4Context* ctx, const char** token, size_t n_threads,
                            float temp, int32_t top_k, float top_p, float tfs_z, float typical_p,
                            int32_t repeat_last_n, float repeat_penalty, float alpha_presence,
                            float alpha_frequency, int mirostat, float mirostat_tau,
                            float mirostat_eta, int penalize_nl) {
    (void)n_threads;
    return end_chat_common(ctx, token, temp, top_k, top_p, tfs_z, typical_p, repeat_last_n,
                           repeat_penalty, alpha_presence, alpha_frequency, mirostat, mirostat_tau,
                           mirostat_eta, penalize_nl);
}

int minigpt4_system_prompt(struct MiniGPT4Context* ctx, size_t n_threads) {
    (void)n_threads;
    Gil gil;
    auto* impl = reinterpret_cast<MiniGPT4ContextImpl*>(ctx);
    return call_int_method(impl->host, "system_prompt", nullptr, kFailedToAddString);
}

int minigpt4_begin_chat(struct MiniGPT4Context* ctx, const char* s, size_t n_threads) {
    (void)n_threads;
    Gil gil;
    auto* impl = reinterpret_cast<MiniGPT4ContextImpl*>(ctx);
    PyObject* args = Py_BuildValue("(s)", s);
    int rc = call_int_method(impl->host, "begin_chat", args, kFailedToAddString);
    Py_XDECREF(args);
    return rc;
}

int minigpt4_end_chat(struct MiniGPT4Context* ctx, const char** token, size_t n_threads, float temp,
                      int32_t top_k, float top_p, float tfs_z, float typical_p,
                      int32_t repeat_last_n, float repeat_penalty, float alpha_presence,
                      float alpha_frequency, int mirostat, float mirostat_tau, float mirostat_eta,
                      int penalize_nl) {
    (void)n_threads;
    return end_chat_common(ctx, token, temp, top_k, top_p, tfs_z, typical_p, repeat_last_n,
                           repeat_penalty, alpha_presence, alpha_frequency, mirostat, mirostat_tau,
                           mirostat_eta, penalize_nl);
}

int minigpt4_reset_chat(struct MiniGPT4Context* ctx) {
    Gil gil;
    auto* impl = reinterpret_cast<MiniGPT4ContextImpl*>(ctx);
    return call_int_method(impl->host, "reset_chat", nullptr, kFailedToAddString);
}

int minigpt4_contains_eos_token(const char* s) {
    // pure string rule (minigpt4.cpp:2764-2771): s == "##"
    return std::strcmp(s, "##") == 0 ? kEosToken : kNone;
}

int minigpt4_is_eos(const char* s) {
    // ends_with "###" (minigpt4.cpp:2773-2782)
    size_t n = std::strlen(s);
    if (n >= 3 && std::strcmp(s + n - 3, "###") == 0) return kEos;
    return kNone;
}

int minigpt4_free(struct MiniGPT4Context* ctx) {
    if (!ctx) return kNone;
    Gil gil;
    auto* impl = reinterpret_cast<MiniGPT4ContextImpl*>(ctx);
    PyObject* res = call_method(impl->host, "close", nullptr);
    if (!res) print_py_error();
    Py_XDECREF(res);
    Py_DECREF(impl->host);
    delete impl;
    return kNone;
}

int minigpt4_free_image(struct MiniGPT4Image* image) {
    if (image && image->data) {
        std::free(image->data);
        image->data = nullptr;
    }
    return kNone;
}

int minigpt4_free_embedding(struct MiniGPT4Embedding* embedding) {
    if (embedding && embedding->data) {
        std::free(embedding->data);
        embedding->data = nullptr;
    }
    return kNone;
}

const char* minigpt4_error_code_to_string(int error_code) {
    // mirror of utils.error_code_to_string / magic_enum names
    static const char* names[] = {
        "None", "LoadModelFileHeader", "LoadModelFileVersion", "LoadModelMiniGPT4DataType",
        "LoadLanguageModel", "OpenImage", "ImageSize", "MmapSupport", "FailedToAddString",
        "LLamaProjectionEmbeddingInvalidSize", "FailedToAddEmbedding", "EosToken", "Eos",
        "ImageNot224_244_3", "ImageNotF32", "ImageChannelsExpectedRGB", "ImageFormatExpectedU8",
        "PathDoesNotExist", "DumpModelFileOpen", "OpenCVNotLinked"};
    if (error_code >= 0 && error_code < static_cast<int>(sizeof(names) / sizeof(names[0]))) {
        return names[error_code];
    }
    return "UnknownError";
}

int minigpt4_quantize_model(const char* in_path, const char* out_path, int data_type) {
    init_python();
    if (!g_py_ok) return kLoadModelFileHeader;
    Gil gil;
    PyObject* mod = PyImport_ImportModule("minigpt4_tpu_torch.quantize");
    if (!mod) {
        print_py_error();
        return kLoadModelFileHeader;
    }
    PyObject* fn = PyObject_GetAttrString(mod, "quantize_model");
    Py_DECREF(mod);
    if (!fn) {
        print_py_error();
        return kLoadModelFileHeader;
    }
    PyObject* res = PyObject_CallFunction(fn, "ssi", in_path, out_path, data_type);
    Py_DECREF(fn);
    if (!res) {
        print_py_error();
        return kLoadModelFileHeader;
    }
    int rc = static_cast<int>(PyLong_AsLong(res));
    Py_DECREF(res);
    return rc;
}

void minigpt4_set_verbosity(int verbosity) {
    init_python();
    if (!g_py_ok) return;
    Gil gil;
    PyObject* mod = PyImport_ImportModule("minigpt4_tpu_torch.utils");
    if (!mod) {
        print_py_error();
        return;
    }
    PyObject* res = PyObject_CallMethod(mod, "set_verbosity", "i", verbosity);
    Py_XDECREF(res);
    Py_DECREF(mod);
}

}  // extern "C"
